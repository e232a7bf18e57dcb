"""Multi-process training of the port: the ('data', 'model') mesh and
its layouts (mesh.py), the collectives that carry a gradient
(collectives.py), the GPipe pipeline over the layer stack (pipeline.py),
the real multi-process smoke run (mp_smoke.py) and the probe of what
Gloo takes for CUDA tensors (gloo_probe.py)."""
