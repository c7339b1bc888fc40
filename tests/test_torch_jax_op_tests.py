"""The JAX package's own tests of the ops this slice ports, run on the
port: the module's ``fluid`` (and ``layers``, and ``op_test.fluid``)
swapped for ``paddle_tpu_torch`` with ``monkeypatch``, as
``test_torch_detection.py`` runs the detection OpTests. The modules are
tests/test_ops_nn.py, test_ops_math.py, test_ops_misc.py,
test_loss_ext.py and test_ops_persist.py (every OpTest method and test
function, the parametrized ones at each of their parameters), and the
distribution tests of test_beam_and_distributions.py (which import
``paddle_tpu.layers.distributions`` inside the test: that module name is
pointed at the port's for the call).

The OpTests of test_ops_nn.py and test_ops_math.py draw their data from
their module's shared ``rng`` when they set up, so a case's data depends
on the cases that ran before it in this file, as in the JAX files: run
the file whole (one process, or ``--dist loadfile``). Their float32
central differences are close to their tolerance on some draws
(TestMatmul.test_grad and TestSoftmaxWithCrossEntropy.test_grad fail on
the first draw of their module's rng, in JAX too for the first).

Left out:

* test_ops_misc.py's TestSplitMergeIds, TestMergeIds, TestRefByTrainerId,
  TestCoalesceTensor and test_split_selected_rows: they reach ops
  outside this slice (the parameter server's ``ops/dist_compute.py``);
* test_ops_math.py's TestMul.test_grad: its float32 central differences
  depend on the data the module's shared rng hands it, and it fails in
  the JAX package too when the module's tests run in another order
  (``pytest tests/test_ops_math.py -k TestMul``); ``mul`` is not this
  slice's, and its gradient is held to JAX's in test_torch_tensor_ops.py.
"""

import sys

import pytest

import op_test
import test_beam_and_distributions as jdist
import test_loss_ext
import test_ops_math
import test_ops_misc
import test_ops_nn
import test_ops_persist

import paddle_tpu_torch as fluid
import paddle_tpu_torch.layers.distributions as port_distributions

MODULES = {m.__name__: m for m in (test_ops_nn, test_ops_math, test_ops_misc,
                                   test_loss_ext, test_ops_persist)}
LEFT_OUT = {"TestSplitMergeIds", "TestMergeIds", "TestRefByTrainerId",
            "TestCoalesceTensor", "test_split_selected_rows",
            "TestMul.test_grad"}


def _cases():
    """(module, name, method or None, params) of every test."""
    out = []
    for mname, mod in sorted(MODULES.items()):
        for name in sorted(dir(mod)):
            if name in LEFT_OUT:
                continue
            obj = getattr(mod, name)
            if name.startswith("Test") and isinstance(obj, type):
                out += [(mname, name, meth, None) for meth in sorted(dir(obj))
                        if meth.startswith("test")
                        and f"{name}.{meth}" not in LEFT_OUT]
            elif name.startswith("test_") and callable(obj):
                marks = [m for m in getattr(obj, "pytestmark", [])
                         if m.name == "parametrize"]
                if not marks:
                    out.append((mname, name, None, None))
                    continue
                argnames, values = marks[0].args[:2]
                argnames = [a.strip() for a in argnames.split(",")] \
                    if isinstance(argnames, str) else list(argnames)
                for i, v in enumerate(values):
                    v = v if len(argnames) > 1 else (v,)
                    out.append((mname, name, None,
                                (i, dict(zip(argnames, v)))))
    return out


CASES = _cases()


@pytest.mark.parametrize(
    "mod,name,meth,params", CASES,
    ids=[f"{m}.{n}{'.' + t if t else ''}{'[%d]' % p[0] if p else ''}"
         for m, n, t, p in CASES])
def test_jax_op_tests_hold_for_the_port(mod, name, meth, params,
                                        monkeypatch, tmp_path):
    module = MODULES[mod]
    monkeypatch.setattr(op_test, "fluid", fluid)
    if hasattr(module, "fluid"):
        monkeypatch.setattr(module, "fluid", fluid)
    if hasattr(module, "layers"):
        monkeypatch.setattr(module, "layers", fluid.layers)
    obj = getattr(module, name)
    if meth is not None:
        inst = obj()
        if hasattr(inst, "setup_method"):
            inst.setup_method(getattr(inst, meth))
        getattr(inst, meth)()
    elif params is not None:
        obj(**params[1])
    elif "tmp_path" in obj.__code__.co_varnames[:obj.__code__.co_argcount]:
        obj(tmp_path)
    else:
        obj()


DISTRIBUTION_TESTS = ["test_normal_distribution_stats",
                      "test_normal_logprob_and_kl", "test_uniform_distribution",
                      "test_categorical_entropy_kl_logprob_sample",
                      "test_multivariate_normal_diag"]


@pytest.mark.parametrize("name", DISTRIBUTION_TESTS)
def test_jax_distribution_tests_hold_for_the_port(name, monkeypatch):
    monkeypatch.setattr(jdist, "fluid", fluid)
    monkeypatch.setitem(sys.modules, "paddle_tpu.layers.distributions",
                        port_distributions)
    getattr(jdist, name)()


def test_every_module_ran_a_case():
    assert {m for m, *_ in CASES} == set(MODULES)
    assert len(CASES) >= 40
