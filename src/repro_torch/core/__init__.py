"""Core datatypes of the serving cluster (``types``)."""
