"""The benchmark's harness: it finds a cell's configuration, traffic mix and
metrics by name, drives the program through its public entry points over a
timed window, and judges what the window produced against ``reference``."""
