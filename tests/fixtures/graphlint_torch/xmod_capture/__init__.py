"""Cross-module capture fixture package (parse-only): the capture region
lives in loop.py; every finding it causes lives in a module it reaches
through the call graph — an imported helper, an override reached by
virtual dispatch, a property read."""
