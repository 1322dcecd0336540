"""The port's native host helper: ``host_sampler.cpp`` (the PCG32 batch
sampler behind ``utils.data.HostImageSampler``), built with g++ at first use
by ``native``. It is the port's own copy; the JAX package's library is never
loaded."""

from . import native

__all__ = ["native"]
