"""The benchmark's plain reference: the encoder, RawBoost, SupCon, the
first training steps and the scorer in plain PyTorch (fp32, TF32 off).
It imports nothing of the program it judges, nor JAX."""
