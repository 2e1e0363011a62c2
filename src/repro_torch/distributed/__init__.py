"""Sharding specs, the installed mesh and parameter placement (the port of
the reference's `distributed/`)."""
