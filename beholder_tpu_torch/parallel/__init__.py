"""The port's parallel stack: so far the ``sp`` mesh that ring attention
runs on (:mod:`beholder_tpu_torch.parallel.mesh`)."""

from .mesh import Mesh

__all__ = ["Mesh"]
