"""The paper's synthetic collections and query workloads (numpy, host)."""
