"""The port's graph core: ids, codecs, schema, configuration, management,
the graph and the columnar bulk loader (the parts of ``janusgraph_tpu/core``
that the stored-graph OLAP path runs)."""
