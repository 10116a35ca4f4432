"""Run-time services of the port: generator snapshots."""
