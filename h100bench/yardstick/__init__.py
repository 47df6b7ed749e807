"""The benchmark's yardstick: FLOP and byte counts from shapes, the table
of the card's peaks, and the reading of a device trace. Frozen: later
changes to the program do not move it."""
