"""Multi-process training of the port: the ('data', 'model') mesh and
its layouts (mesh.py), the collectives that carry a gradient
(collectives.py) and the real multi-process smoke run (mp_smoke.py)."""
