"""`python -m janusgraph_tpu_torch` entry point (``cli.py``).

The __name__ guard matters: without it, merely *importing*
``janusgraph_tpu_torch.__main__`` (pkgutil walkers, import sweeps, doc
generators) would run the CLI against the importer's argv.
"""

from janusgraph_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
