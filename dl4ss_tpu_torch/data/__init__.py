"""Data sources: wav I/O and resampling, the synthetic bank and mixture
synthesis, speaker trees, the wsj0-mix lists, the native loader's banks,
the device prefetch and the rehearsal-corpus generator."""
