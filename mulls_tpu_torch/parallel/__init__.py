"""Device mesh, multi-sequence and multi-process helpers — port of
``mulls_tpu/parallel``.

Lazy re-exports (PEP 562), as in the reference: importing
``mulls_tpu_torch.parallel.distributed`` loads nothing of the mesh's step
or the pipeline until a name below is asked for.
"""

__all__ = ["make_mesh", "batched_icp", "distributed_slam_step"]


def __getattr__(name):
    if name in __all__:
        from mulls_tpu_torch.parallel import mesh
        return getattr(mesh, name)
    raise AttributeError(name)
