"""The harness's general parts: finding a cell's files by name, the
measured window, the trace and its reduction, the comparison's
arithmetic, and the device checks."""
