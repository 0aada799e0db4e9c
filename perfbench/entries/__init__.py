"""The program's entry points, one module each, found by the name that a
traffic file gives under ``entry`` (see ``spec.entry``)."""
