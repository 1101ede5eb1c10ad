"""CPU tests of the benchmark (and one test on the card)."""
