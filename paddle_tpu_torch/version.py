"""Version metadata: the port's copy of ``paddle_tpu/version.py`` (the
reference's generated version.py, python/setup.py.in:67
``write_version_py``: full_version / major / minor / patch / rc /
istaged / commit / show()). JAX's build flag ``with_tpu`` / ``tpu()``
has its counterpart here in ``with_cuda`` / ``cuda()``: "ON" where
PyTorch was built with CUDA."""

import torch

full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
istaged = True
commit = "unknown"
with_cuda = "ON" if torch.version.cuda else "OFF"


def show():
    if istaged:
        print("full_version:", full_version)
        print("major:", major)
        print("minor:", minor)
        print("patch:", patch)
        print("rc:", rc)
    else:
        print("commit:", commit)


def cuda():
    return with_cuda
