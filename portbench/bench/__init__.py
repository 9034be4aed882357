"""The harness: discovery by name, the run of one cell, the device trace
and the launch of rank processes."""
