"""CPU tests of the benchmark; the ones marked gpu run on the card."""
