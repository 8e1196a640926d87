"""Training of the port: the resident-data `Trainer` (loop.py), RAdam
with the reference's clipping, decay split and schedule (optim.py), the
tasks of the VQ-VAE and the transformer (tasks.py), their metrics
(metrics.py), checkpoint files with the optimizer's state
(checkpoint.py) and the reading half of the reference Lightning format
(torch_import.py)."""
