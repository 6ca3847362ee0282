"""Runtime checks of the port's relocation data plane."""
