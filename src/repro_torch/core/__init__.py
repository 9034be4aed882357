"""The paper's search loop: guarantees, index artifact, Algorithm 2."""
