"""Data-input layer: the port's copy of ``paddle_tpu/layers/io.py``
(Fluid's python/paddle/fluid/layers/io.py data())."""

from __future__ import annotations

from ..core.framework import default_main_program, default_startup_program


def data(
    name,
    shape,
    append_batch_size: bool = True,
    dtype="float32",
    lod_level: int = 0,
    type=None,
    stop_gradient: bool = True,
):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    main = default_main_program()
    var = main.global_block().create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        is_data=True,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
    )
    # also declare in startup program for reference parity (harmless)
    default_startup_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, is_data=True, stop_gradient=True
    )
    return var
