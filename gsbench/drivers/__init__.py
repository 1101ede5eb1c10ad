"""The drivers of the kinds of traffic, one module a kind, found by the
``kind`` a mix's file names (see ``harness.load_driver``)."""
