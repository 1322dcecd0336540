"""The port's samples, each run as ``python -m tcnn_tpu_torch.samples.<name>``:
``mlp_learning_an_image`` (the image fit) and ``nerf_synthetic`` (an NGP
radiance field on an analytic scene). They run on the CUDA card unless
given ``--device cpu``."""
