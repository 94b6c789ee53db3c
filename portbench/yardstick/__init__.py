"""The benchmark's frozen arithmetic: the card's data-sheet peaks, K1's
operations and bytes, the model's FLOPs, and the statistics the metrics
are read with. Copied from the program where it had them, so that the
yardstick does not move when the program does."""
