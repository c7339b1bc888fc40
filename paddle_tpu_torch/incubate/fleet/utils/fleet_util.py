"""Fleet training utilities: the port's copy of
``paddle_tpu/incubate/fleet/utils/fleet_util.py`` (reference
incubate/fleet/utils/fleet_util.py): rank-0 logging, metric-state reset,
the global AUC and metrics from the auc op's stat buckets, and model
save / load wrappers. The reference sums the stats over MPI; here they
are summed over the ``torch.distributed`` world when one is initialised
(gloo on the host, NCCL on the card), and one process is its own world.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .... import io
from ....core.executor import global_scope, to_numpy

__all__ = ["FleetUtil"]

_logger = logging.getLogger("paddle_tpu_torch.fleet_util")


def _world():
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


def _host(value) -> np.ndarray:
    return to_numpy(value) if isinstance(value, torch.Tensor) \
        else np.asarray(value)


class FleetUtil(object):
    def __init__(self, mode="pslib"):
        self._mode = mode

    # -- rank-0 logging ----------------------------------------------------
    def _rank(self) -> int:
        """This worker's index: fleet's, once ``fleet.init`` ran, else
        the ``torch.distributed`` world's. Rank 0 only with neither, in
        one process. JAX's answers 0 on any exception (:24-28), which
        would let every worker of a broken fleet act as rank 0."""
        from ....parallel.fleet import fleet

        if fleet._role_maker is not None:
            return fleet.worker_index()
        world = _world()
        return world.get_rank() if world is not None else 0

    def rank0_print(self, s):
        if self._rank() == 0:
            print(s, flush=True)

    def rank0_info(self, s):
        if self._rank() == 0:
            _logger.info(s)

    def rank0_error(self, s):
        if self._rank() == 0:
            _logger.error(s)

    # -- metric state ------------------------------------------------------
    def set_zero(self, var_name, scope=None, place=None, param_type="int64"):
        """Reset a metric-state variable to zeros (reference :121), on
        the device it lives on."""
        scope = scope or global_scope()
        var = scope.find_var(var_name)
        if var is None:
            raise KeyError(f"variable {var_name!r} not found in scope")
        scope.set_var(var_name, torch.zeros_like(var)
                      if isinstance(var, torch.Tensor)
                      else np.zeros_like(np.asarray(var)))

    def get_global_auc(self, scope=None, stat_pos="_generated_var_2",
                       stat_neg="_generated_var_3"):
        """AUC from the auc op's positive / negative bucket stats,
        summed across workers (reference :186)."""
        scope = scope or global_scope()
        pos = _host(scope.find_var(stat_pos)).astype("float64").ravel()
        neg = _host(scope.find_var(stat_neg)).astype("float64").ravel()
        pos, neg = self._all_reduce(pos), self._all_reduce(neg)
        # trapezoid over buckets, descending threshold
        tot_pos = tot_neg = area = 0.0
        for b in range(len(pos) - 1, -1, -1):
            new_pos = tot_pos + pos[b]
            new_neg = tot_neg + neg[b]
            area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0.0 or tot_neg == 0.0:
            return 0.5
        return float(area / (tot_pos * tot_neg))

    def print_global_auc(self, scope=None, stat_pos="_generated_var_2",
                         stat_neg="_generated_var_3",
                         print_prefix=""):
        auc = self.get_global_auc(scope, stat_pos, stat_neg)
        self.rank0_print(f"{print_prefix} global auc = {auc:.6f}")
        return auc

    def get_global_metrics(self, scope=None, stat_pos_name="_generated_var_2",
                           stat_neg_name="_generated_var_3",
                           sqrerr_name=None, abserr_name=None,
                           prob_name=None, q_name=None, pos_ins_num_name=None,
                           total_ins_num_name=None):
        """auc and the error metrics from named stat vars (reference
        :1268). Unavailable stats come back as None."""
        scope = scope or global_scope()
        out = {"auc": self.get_global_auc(scope, stat_pos_name,
                                          stat_neg_name)}

        def summed(name):
            return float(self._all_reduce(
                _host(scope.find_var(name)).astype("float64")).sum())

        def mean_of(name, denom):
            if name is None or scope.find_var(name) is None:
                return None
            return summed(name) / denom if denom else None

        total = None
        if total_ins_num_name and scope.find_var(total_ins_num_name) is not None:
            total = summed(total_ins_num_name)
            out["total_ins_num"] = total
        out["mae"] = mean_of(abserr_name, total)
        sqr = mean_of(sqrerr_name, total)
        out["rmse"] = sqr ** 0.5 if sqr is not None else None
        out["predicted_ctr"] = mean_of(prob_name, total)
        if pos_ins_num_name and scope.find_var(pos_ins_num_name) is not None and total:
            out["actual_ctr"] = summed(pos_ins_num_name) / total
        return out

    def print_global_metrics(self, print_prefix="", **kwargs):
        m = self.get_global_metrics(**kwargs)
        self.rank0_print(f"{print_prefix} global metrics: " + ", ".join(
            f"{k}={v}" for k, v in m.items() if v is not None))
        return m

    # -- checkpoints -------------------------------------------------------
    def save_fleet_model(self, path, mode=0, main_program=None):
        """Every persistable of the program, written by rank 0."""
        if self._rank() == 0:
            io.save_persistables(None, path, main_program)

    def load_fleet_model(self, path, mode=0, executor=None,
                         main_program=None):
        """``save_fleet_model``'s arrays into the scope, on
        ``executor``'s device (the card when None)."""
        io.load_persistables(executor, path, main_program)

    def save_model(self, output_path, day, pass_id):
        self.save_fleet_model(os.path.join(
            str(output_path), str(day), str(pass_id)))

    # -- scheduling helper -------------------------------------------------
    def get_online_pass_interval(self, days, hours, split_interval,
                                 split_per_pass, is_data_hourly_placed):
        """Pass interval layout for online training (reference :1207)."""
        split_interval = int(split_interval)
        split_per_pass = int(split_per_pass)
        splits_per_day = 24 * 60 // split_interval
        pass_per_day = splits_per_day // split_per_pass
        online_pass_interval = []
        for i in range(pass_per_day):
            online_pass_interval.append([])
            for j in range(split_per_pass):
                split_idx = i * split_per_pass + j
                h = split_idx * split_interval // 60
                m = split_idx * split_interval % 60
                if is_data_hourly_placed:
                    online_pass_interval[-1].append(f"{h:02d}")
                else:
                    online_pass_interval[-1].append(f"{h:02d}{m:02d}")
        return online_pass_interval

    def _all_reduce(self, arr: np.ndarray) -> np.ndarray:
        """``arr`` summed over the world's ranks (itself in one
        process)."""
        world = _world()
        if world is None or world.get_world_size() == 1:
            return arr
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float64))
        if world.get_backend() == "nccl":
            t = t.cuda()
        world.all_reduce(t)
        return t.cpu().numpy()
