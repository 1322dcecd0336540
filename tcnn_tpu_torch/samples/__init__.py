"""The port's samples, each run as ``python -m tcnn_tpu_torch.samples.<name>``:
``mlp_learning_an_image`` (the image fit). They run on the CUDA card unless
given ``--device cpu``."""
