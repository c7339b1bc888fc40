"""The port's public-surface ratchet: every line of the JAX package's
API spec (``paddle_tpu.api.spec``) resolves under ``paddle_tpu_torch``.

Each line's dotted name, its root swapped for ``paddle_tpu_torch``, is
resolved as a user reaches it: the longest prefix that imports as a
module, then ``getattr`` for the rest. The spec is read as text; nothing
here imports JAX (JAX's own spec test, ``test_api_spec.py``, checks JAX
against the file).

Three exact lists name what does not resolve:

* ``TPU_ONLY``: JAX's names for the TPU. Each has a CUDA counterpart,
  which must resolve, or is refused by name: reaching it raises
  ``AttributeError`` naming the CUDA counterpart.
* ``NOT_YET_A11I``: slim's NAS (ROADMAP A11i).
* ``NOT_YET_A11K``: the autotune names of ``flags`` (ROADMAP A11k).

The test fails if a listed name resolves (a list only shrinks; a name
ported later leaves its list) or if any other name does not.
``TPU_KEPT`` records the TPU names that resolve with a CUDA meaning.
"""

import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(REPO, "paddle_tpu.api.spec")

# name -> ("analogue", the port's name that stands for it) or
#         ("refused", the CUDA counterpart the refusal names)
TPU_ONLY = {
    "paddle_tpu.TPUPlace": ("refused", "CUDAPlace"),
    "paddle_tpu.TPUPlace.jax_device": ("refused", "CUDAPlace"),
    "paddle_tpu.Place.jax_device":
        ("analogue", "paddle_tpu_torch.Place.torch_device"),
    "paddle_tpu.CPUPlace.jax_device":
        ("analogue", "paddle_tpu_torch.CPUPlace.torch_device"),
    "paddle_tpu.CUDAPlace.jax_device":
        ("analogue", "paddle_tpu_torch.CUDAPlace.torch_device"),
    "paddle_tpu.Executor.aot_compile": ("refused", "Executor.bind"),
    "paddle_tpu.io.Executor.aot_compile": ("refused", "Executor.bind"),
    "paddle_tpu.kernels.layer_norm_pallas":
        ("refused", "kernels.layer_norm"),
}

# TPU names that resolve, with the CUDA meaning they have in the port
TPU_KEPT = {
    "paddle_tpu.is_compiled_with_tpu": "returns False",
    "paddle_tpu.Executor.export_fn":
        "the bound step, its example tensors and their names",
    "paddle_tpu.io.Executor.export_fn":
        "the bound step, its example tensors and their names",
}

NOT_YET_A11I = {
    "paddle_tpu.contrib.slim.nas.ControllerClient",
    "paddle_tpu.contrib.slim.nas.ControllerClient.next_tokens",
    "paddle_tpu.contrib.slim.nas.ControllerClient.update",
    "paddle_tpu.contrib.slim.nas.ControllerServer",
    "paddle_tpu.contrib.slim.nas.ControllerServer.close",
    "paddle_tpu.contrib.slim.nas.ControllerServer.start",
    "paddle_tpu.contrib.slim.nas.LightNAS",
    "paddle_tpu.contrib.slim.nas.LightNAS.search",
    "paddle_tpu.contrib.slim.nas.SAController",
    "paddle_tpu.contrib.slim.nas.SAController.next_tokens",
    "paddle_tpu.contrib.slim.nas.SAController.reset",
    "paddle_tpu.contrib.slim.nas.SAController.update",
    "paddle_tpu.contrib.slim.nas.SearchSpace",
    "paddle_tpu.contrib.slim.nas.SearchSpace.create_net",
    "paddle_tpu.contrib.slim.nas.SearchSpace.get_model_latency",
    "paddle_tpu.contrib.slim.nas.SearchSpace.init_tokens",
    "paddle_tpu.contrib.slim.nas.SearchSpace.range_table",
}

NOT_YET_A11K = {
    "paddle_tpu.flags.AutotuneProfileMismatch",
    "paddle_tpu.flags.AutotuneProfileMismatch.with_traceback",
    "paddle_tpu.flags.apply_autotune_profile",
    "paddle_tpu.flags.autotune_apply_for",
    "paddle_tpu.flags.autotune_dir",
    "paddle_tpu.flags.autotune_profile_path",
    "paddle_tpu.flags.save_autotune_profile",
}


def spec_names():
    with open(SPEC) as f:
        return [ln.split(" ", 1)[0] for ln in (s.strip() for s in f) if ln]


def port_name(name):
    return "paddle_tpu_torch" + name[len("paddle_tpu"):]


def resolve(name):
    """The object ``name`` (a port name) names, reached as a user
    reaches it. Raises what the last step raises."""
    parts = name.split(".")
    obj, i = None, len(parts)
    while i > 0:
        try:
            obj = importlib.import_module(".".join(parts[:i]))
            break
        except ImportError:
            i -= 1
    for p in parts[i:]:
        obj = getattr(obj, p)
    return obj


def resolves(name):
    try:
        resolve(port_name(name))
    except AttributeError:
        return False
    return True


def test_the_spec_is_read():
    names = spec_names()
    assert len(names) == 1819 and len(set(names)) == len(names)
    listed = set(TPU_ONLY) | NOT_YET_A11I | NOT_YET_A11K | set(TPU_KEPT)
    assert listed <= set(names), sorted(listed - set(names))


def test_every_spec_name_resolves_but_the_listed_ones():
    listed = set(TPU_ONLY) | NOT_YET_A11I | NOT_YET_A11K
    missing = [n for n in spec_names() if n not in listed and not resolves(n)]
    assert not missing, missing


@pytest.mark.parametrize("group", ["TPU_ONLY", "NOT_YET_A11I",
                                   "NOT_YET_A11K"])
def test_a_listed_name_does_not_resolve(group):
    """A list only shrinks: a name that resolves leaves its list."""
    names = {"TPU_ONLY": set(TPU_ONLY), "NOT_YET_A11I": NOT_YET_A11I,
             "NOT_YET_A11K": NOT_YET_A11K}[group]
    assert len(names) == {"TPU_ONLY": 8, "NOT_YET_A11I": 17,
                          "NOT_YET_A11K": 7}[group]
    resolved = sorted(n for n in names if resolves(n))
    assert not resolved, resolved


@pytest.mark.parametrize("name", sorted(TPU_ONLY))
def test_tpu_only_names_have_a_cuda_counterpart(name):
    kind, other = TPU_ONLY[name]
    if kind == "analogue":
        assert callable(resolve(other))
        return
    parts = port_name(name).split(".")
    if parts[-1] == "aot_compile":
        # a method refused on the instance a user holds
        import paddle_tpu_torch as fluid

        with pytest.raises(AttributeError, match=other):
            fluid.Executor(fluid.CPUPlace()).aot_compile
        return
    with pytest.raises(AttributeError, match=other):
        resolve(port_name(name))


def test_tpu_kept_names_have_their_cuda_meaning():
    import numpy as np

    import paddle_tpu_torch as fluid

    assert fluid.is_compiled_with_tpu() is False
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.reduce_sum(fluid.layers.fc(x, 3))
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).randn(2, 4).astype("float32")}
    fn, args, meta = exe.export_fn(main, feed, [y], scope=scope)
    assert meta["feed_names"] == ["x"] and meta["fetch_names"] == [y.name]
    assert set(meta["state_names"]) == {p.name for p in main.all_parameters()}
    (got,) = fn(args)
    (want,) = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["debugger", "generation", "incubate",
                                  "install_check", "quantize", "traffic"])
def test_top_level_modules_load_on_first_use(name):
    """``import paddle_tpu_torch`` does not load these modules; the
    attribute imports one on first use and is the module itself."""
    import subprocess
    import sys

    code = ("import sys, paddle_tpu_torch as f\n"
            f"m = 'paddle_tpu_torch.{name}'\n"
            "assert m not in sys.modules, m\n"
            f"assert f.{name} is sys.modules[m]\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
