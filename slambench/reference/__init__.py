"""The plain reference that decides ``correct`` (see slambench/README.md).

``dense.py`` is a dense splatting renderer, the losses and the three
phases written from the method; ``check.py`` works the recorded steps out
again through it and compares.  Nothing here imports jax, hierslam_tpu,
hierslam_torch or the copies of the program in ``slambench/frozen``."""
