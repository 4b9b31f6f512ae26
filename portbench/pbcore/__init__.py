"""The benchmark's own modules: cells, inputs, drive, trace, yardstick."""
