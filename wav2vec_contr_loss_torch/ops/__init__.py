"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, and the int16 waveform wire format."""
