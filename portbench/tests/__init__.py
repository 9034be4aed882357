"""CPU tests of the benchmark: the plain reference, the comparison, the
harness's pieces at a tiny size with the port on the CPU, discovery by
name, the imports and the launch of rank processes."""
