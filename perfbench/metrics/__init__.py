"""Per-layer metric readers: ``<metric>.py`` holds ``read(records)``,
which returns the metric's value from a traced run's records, or None
where it finds nothing to read (see ``perfbench/README.md``)."""
