"""The benchmark's harness: files found by name, traffic drivers, the systems
under test, tracing, the check and the yardstick."""
