"""The port's samples, each run as ``python -m tcnn_tpu_torch.samples.<name>``:
``mlp_learning_an_image`` (the image fit), ``nerf_synthetic`` (an NGP
radiance field on an analytic scene), ``sdf_learning`` (a signed distance
field with an eikonal term: second order through the grid kernels),
``realtime_render`` (train an image field, then serve static and moving
frames through a ``FrozenServer``) and ``fused_ray_marcher`` (a ray march
with the model inlined, captured as one CUDA graph). They run on the CUDA
card unless given ``--device cpu``."""
