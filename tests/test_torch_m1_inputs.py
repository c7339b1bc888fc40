"""The inputs ``chip_smoke.py`` phase m1 drives the new lowerings with on
the card: the sweep rows (tests/test_op_sweep.py ``SPECS``) and the
``CASES`` of the ``test_torch_sweep_*`` twins for the ops of this slice,
written to ``probes/m1_inputs.npz`` (the arrays under ``case/slot/i``,
the rows under ``__cases__`` as JSON). chip_smoke.py cannot import the
sweep (it imports the JAX package), so the rows travel as data; this test
holds the file to the rows, and ``python tests/test_torch_m1_inputs.py``
writes it anew.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.path.join(os.path.dirname(HERE), "probes", "m1_inputs.npz")


def m1_rows():
    """{case: (op, {slot: [arrays]}, attrs, grads, n_out)}."""
    from test_op_sweep import SPECS
    import test_torch_sweep_loss as loss
    import test_torch_sweep_misc as misc
    import test_torch_sweep_nn as nn
    import test_torch_sweep_tensor as tensor

    rows = {}
    for ops in tensor.NEW_OPS.values():
        for op in ops:
            if op in SPECS and op not in tensor.RANDOM:
                sp = SPECS[op]
                rows[op] = (op, sp["inputs"], sp["attrs"], list(sp["grads"]),
                            sp["n_out"])
    for mod in (tensor, nn, loss, misc):
        for name, (op, inputs, attrs, grads) in mod.CASES.items():
            rows[f"{mod.__name__[11:]}:{name}"] = (op, inputs, attrs,
                                                   list(grads), {})
    return rows


def _flatten(rows):
    arrays, cases = {}, {}
    for case, (op, inputs, attrs, grads, n_out) in sorted(rows.items()):
        slots = {}
        for slot, vals in inputs.items():
            vals = vals if isinstance(vals, list) else [vals]
            slots[slot] = len(vals)
            for i, v in enumerate(vals):
                arrays[f"{case}/{slot}/{i}"] = np.asarray(v)
        cases[case] = {"op": op, "inputs": slots, "attrs": attrs,
                       "grads": grads, "n_out": n_out}
    return arrays, cases


def write(path=PATH):
    arrays, cases = _flatten(m1_rows())
    np.savez_compressed(path, __cases__=np.array(json.dumps(cases)),
                        **arrays)


def test_the_card_inputs_are_the_sweep_rows():
    arrays, cases = _flatten(m1_rows())
    with np.load(PATH) as z:
        assert json.loads(str(z["__cases__"])) == json.loads(
            json.dumps(cases))
        assert sorted(k for k in z.files if k != "__cases__") == \
            sorted(arrays)
        for k, v in arrays.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    from test_torch_sweep_tensor import NEW_OPS

    covered = {c["op"] for c in cases.values()}
    # the random, host and persisting ops are driven by chip_smoke.py's
    # own code: statistics, a host call, a file round trip
    own_code = {"shuffle_batch", "random_crop", "randint",
                "truncated_gaussian_random", "uniform_random_batch_size_like",
                "gaussian_random_batch_size_like", "sampling_id",
                "py_func", "py_func_grad", "save", "load", "save_combine",
                "load_combine", "average_accumulates"}
    new = {n for ops in NEW_OPS.values() for n in ops}
    assert new - covered == own_code


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    write()
    print(f"wrote {PATH}")
