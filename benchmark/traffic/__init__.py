"""Traffic runners: one module per runner, named by the ``runner`` of a
traffic mix's file."""
