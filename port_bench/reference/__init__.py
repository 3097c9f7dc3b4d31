"""The plain reference of the benchmarked pipelines: plain PyTorch and
NumPy that import nothing of the program (``tracknetv3_tpu_torch``) and
nothing of JAX. It follows the published TrackNetV3 (its ``model.py``,
``predict.py`` and ``test.py`` rules) and takes only what the benchmark
itself made: the seeded weights, the frames and their labels."""
