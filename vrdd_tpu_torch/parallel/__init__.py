"""The distributed renderers on a ``(bricks, rays)`` mesh (counterpart of
``vrdd_tpu/parallel``): ``mesh`` (the mesh and its collectives), ``sweep``
(the sort-last slice sweep, scalar and histogram, unrotated and
shear-warp), ``bricks`` (the scan marcher on z-slabs), ``train`` (the
fitting steps), ``multihost`` (processes) and ``scaling``."""
