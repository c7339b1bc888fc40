"""Dataset-authoring API: the port's copy of
``paddle_tpu/incubate/data_generator/__init__.py`` (reference
python/paddle/fluid/incubate/data_generator/__init__.py:21
DataGenerator, :241 MultiSlotStringDataGenerator, :282
MultiSlotDataGenerator).

Users subclass a generator, implement generate_sample(line), and run
it as the dataset pipe command (or write files directly). The emitted
MultiSlot text lines (per slot: "<n> v1 ... vn") are the JAX package's
bytes, and what ``paddle_tpu_torch.dataset``'s parsers (Python, or
``native/datafeed.cpp``) read, so a generator round-trips into
``Dataset.set_filelist`` / ``load_into_memory``.
"""

from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    """Reference data_generator/__init__.py:21."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    # -- user hooks -----------------------------------------------------------
    def generate_sample(self, line):
        """Subclass hook: return a generator yielding ONE sample — a
        list of (slot_name, value_list) pairs — or None to drop the
        line."""
        raise NotImplementedError(
            "Please rewrite this function to return a list or tuple: " +
            "[(name, [value1, value2]), ...]")

    def generate_batch(self, samples):
        """Subclass hook: batch-level postprocessing; yields samples."""
        for sample in samples:
            yield sample

    # -- run modes ------------------------------------------------------------
    def run_from_stdin(self):
        """Pipe-command mode: stdin lines -> stdout MultiSlot lines."""
        batch = []
        for line in sys.stdin:
            it = self.generate_sample(line)
            if it is None:
                continue
            for sample in it():
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size_:
                    self._flush(batch, sys.stdout)
                    batch = []
        if batch:
            self._flush(batch, sys.stdout)

    def run_from_memory(self):
        """Memory mode: generate_sample(None) produces every sample."""
        batch = []
        it = self.generate_sample(None)
        for sample in it():
            if sample is None:
                continue
            batch.append(sample)
            if len(batch) == self.batch_size_:
                self._flush(batch, sys.stdout)
                batch = []
        if batch:
            self._flush(batch, sys.stdout)

    def write_to_files(self, lines_per_file, prefix):
        """Beyond the reference, as JAX's: write the generated samples
        as dataset shard files of ``lines_per_file`` lines and return
        their paths (what a pipe command would have produced)."""
        paths = []
        f = None
        n = 0
        it = self.generate_sample(None)
        for sample in it():
            if sample is None:
                continue
            if f is None or n >= lines_per_file:
                if f:
                    f.close()
                paths.append(f"{prefix}.{len(paths):04d}.txt")
                f = open(paths[-1], "w")
                n = 0
            f.write(self._gen_str(sample))
            n += 1
        if f:
            f.close()
        return paths

    def _flush(self, batch, out):
        for sample in self.generate_batch(batch):
            out.write(self._gen_str(sample))

    def _gen_str(self, line):
        raise NotImplementedError(
            "Please inherit MultiSlotDataGenerator or "
            "MultiSlotStringDataGenerator to use this function")


class MultiSlotStringDataGenerator(DataGenerator):
    """Reference :241 — values are already strings."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of process() must be in list or tuple type")
        out = []
        for _, elements in line:
            out.append(str(len(elements)))
            out.extend(str(e) for e in elements)
        return " ".join(out) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """Reference :282 — validates slot names/arity are stable across
    samples, values numeric."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of process() must be in list or tuple type")
        if self._proto_info is None:
            self._proto_info = [(name, "uint64"
                                 if all(isinstance(e, int) for e in elements)
                                 else "float") for name, elements in line]
        else:
            if len(line) != len(self._proto_info):
                raise ValueError(
                    "the complete field set of two given line are "
                    "inconsistent.")
            for (name, elements), (pname, _) in zip(line, self._proto_info):
                if name != pname:
                    raise ValueError(
                        "the field name of two given line are not match: "
                        f"{name} != {pname}")
        out = []
        for name, elements in line:
            if not elements:
                raise ValueError(
                    f"the field {name} of a sample must have at least one "
                    "element")
            out.append(str(len(elements)))
            out.extend(str(e) for e in elements)
        return " ".join(out) + "\n"
