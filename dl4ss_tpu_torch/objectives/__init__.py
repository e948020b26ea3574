"""Training objectives: uPIT assignment and the reference's losses."""
