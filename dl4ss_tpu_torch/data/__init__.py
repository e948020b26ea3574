"""Host-side data helpers (numpy / scipy): wav I/O and resampling."""
