"""Collective transpilers: the port's counterpart of
``paddle_tpu/transpiler/collective.py`` (reference
transpiler/collective.py:36 Collective, :178 GradAllReduce, :270
LocalSGD, :377 SingleProcessMultiThread).

``GradAllReduce`` inserts ``c_allreduce_sum`` and a ``1/nranks`` scale
after each parameter gradient's final producer; ``LocalSGD`` averages
the parameters every ``local_steps`` steps behind a
``local_sgd_select`` gate. Run by a plain ``Executor`` in a world
(``python -m paddle_tpu_torch.distributed.launch``), the ops reduce
over the world's process group (``ops/collective.py``); run by one
process with no world, a program transpiled for N > 1 trainers raises
(``core/executor.py``), as the JAX package's does.
"""

from __future__ import annotations

from ..core.framework import OpRole, Program


class Collective:
    def __init__(self, nrings: int = 1):
        self.nrings = nrings

    def transpile(self, startup_program, main_program, rank, endpoints,
                  current_endpoint, wait_port=True):
        self.rank = rank
        self.endpoints = endpoints if isinstance(endpoints, list) else endpoints.split(",")
        self.nranks = len(self.endpoints)
        self.startup_program = startup_program or Program()
        self.main_program = main_program or Program()
        self._transpile_startup_program()
        self._transpile_main_program()
        # nrings is part of the plan (the rings the startup program
        # initializes)
        self.main_program._dist_plan = {
            "mode": "collective", "trainer_id": rank, "trainers": self.nranks,
            "nrings": self.nrings,
        }

    def _transpile_startup_program(self):
        # reference inserts c_gen_nccl_id + c_comm_init per ring
        # (collective.py:99-131); both lower to no-ops (the world is
        # formed by init_parallel_env) but are kept for program parity
        block = self.startup_program.global_block()
        for ring_id in range(self.nrings):
            block.append_op(
                type="c_comm_init",
                attrs={"ring_id": ring_id, "nranks": self.nranks, "rank": self.rank},
            )
        self.startup_program._bump()

    def _transpile_main_program(self):
        pass


class GradAllReduce(Collective):
    """Reference collective.py:178."""

    def _transpile_main_program(self):
        from ..core.framework import Parameter

        block = self.main_program.global_block()

        def is_param_grad(n):
            # ONLY parameter grads are averaged (reference keys on
            # op_role_var param/grad pairs, collective.py:196);
            # averaging intermediate activation grads would corrupt
            # the earlier layers' chain rule
            if not n.endswith("@GRAD"):
                return False
            base = n[: -len("@GRAD")]
            v = block.vars.get(base)
            return isinstance(v, Parameter) and v.trainable

        # param grads that a later Backward `sum` op re-produces (the
        # rename-and-sum scheme for multi-consumer params): allreduce
        # only after the final sum, not after every partial
        summed_later = {
            n
            for op in block.ops
            if op.type == "sum" and int(op.attrs.get("op_role", 0)) & OpRole.Backward
            for names in op.outputs.values()
            for n in names
            if n.endswith("@GRAD")
        }
        new_ops = []
        ring = 0
        for op in block.ops:
            new_ops.append(op)
            # "sum" included: multi-consumer params get their final
            # @GRAD from the rename-and-sum op, not a *_grad op
            if int(op.attrs.get("op_role", 0)) & OpRole.Backward and (
                op.type.endswith("_grad") or op.type == "sum"
            ):
                for names in op.outputs.values():
                    for n in names:
                        if not is_param_grad(n):
                            continue
                        if op.type != "sum" and n in summed_later:
                            continue
                        ar = type(op)(
                            block, "c_allreduce_sum",
                            inputs={"X": [n]}, outputs={"Out": [n]},
                            attrs={"ring_id": ring % self.nrings,
                                   "op_role": OpRole.Backward},
                        )
                        new_ops.append(ar)
                        sc = type(op)(
                            block, "scale",
                            inputs={"X": [n]}, outputs={"Out": [n]},
                            attrs={"scale": 1.0 / self.nranks,
                                   "op_role": OpRole.Backward},
                        )
                        new_ops.append(sc)
                        ring += 1
        block.ops = new_ops
        self.main_program._bump()


class LocalSGD(Collective):
    """Reference collective.py:270 — periodic cross-replica parameter
    averaging instead of per-step grad allreduce."""

    def __init__(self, nrings: int = 1, local_steps: int = 4):
        super().__init__(nrings)
        self.local_steps = local_steps

    def _transpile_main_program(self):
        from ..layers.tensor import create_global_var
        from ..core.framework import program_guard, unique_name

        block = self.main_program.global_block()
        with program_guard(self.main_program, self.startup_program):
            step = create_global_var([1], 0, "float32", persistable=True,
                                     name=unique_name.generate("local_sgd_step"))
        block.append_op(type="increment", inputs={"X": [step.name]},
                        outputs={"Out": [step.name]},
                        attrs={"step": 1.0, "op_role": OpRole.Optimize})
        # every local_steps: param = world mean of param. The averaging is
        # emitted unconditionally (static graph) and SELECTED by a
        # where on (step mod local_steps == 0) — real gating, not just
        # a recorded attr.
        k = float(max(self.local_steps, 1))
        for p in self.main_program.all_parameters():
            avg = block.create_var(
                name=unique_name.generate(f"{p.name}.lsgd_avg"),
                shape=p.shape, dtype=p.dtype, stop_gradient=True,
            )
            block.append_op(
                type="c_allreduce_sum", inputs={"X": [p.name]},
                outputs={"Out": [avg.name]},
                attrs={"ring_id": 0, "op_role": OpRole.Optimize},
            )
            block.append_op(
                type="scale", inputs={"X": [avg.name]}, outputs={"Out": [avg.name]},
                attrs={"scale": 1.0 / self.nranks, "op_role": OpRole.Optimize},
            )
            block.append_op(
                type="local_sgd_select",
                inputs={"Step": [step.name], "Avg": [avg.name], "Param": [p.name]},
                outputs={"Out": [p.name]},
                attrs={"every": k, "op_role": OpRole.Optimize},
            )
        self.main_program._bump()


class SingleProcessMultiThread(GradAllReduce):
    """Reference collective.py:377: one process driving its devices; the
    port drives one device a process, so only the annotation remains."""

    def _transpile_startup_program(self):
        pass
