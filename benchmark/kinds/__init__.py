"""Kinds of configuration: one module each, with a ``Cell`` class (see
``benchmark.harness``), named by a configuration's ``kind`` key."""
