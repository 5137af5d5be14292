"""Front-end operators: pyramid, FAST, BRIEF, patch gather, ORB, matching."""
