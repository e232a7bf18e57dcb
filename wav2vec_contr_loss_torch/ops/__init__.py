"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, the int8 serving linears and the int16 waveform wire format.

Importing this package registers the custom ops `w2v_torch::attention_fwd`
and `w2v_torch::ln_gelu_fwd`, which a serving artifact calls."""

from . import attention, conv_ln  # noqa: F401  (register the custom ops)
