"""The host parameter-server runtime, the port's counterpart of
``paddle_tpu/ps/`` (reference operators/distributed/: the RPC stack,
the Communicator's send / recv threads communicator.h:176-383,
listen_and_serv_op.cc's pserver loop, the transpiler's param slicing).

It serves the CTR training mode: embedding tables too large for a
card live as float32 row shards in the pservers' host memory, the
trainer runs the forward and backward on the card and exchanges rows
(sparse tables) and whole gradients and parameters (dense ones) with
the servers. The wire (``protocol.py``) is the JAX package's, byte for
byte: pickle and raw array buffers over TCP, with the verbs of the
reference's send_recv.proto:19-34.
"""

from .client import PSClient, wait_server_ready
from .communicator import Communicator
from .server import ParameterServer, run_pserver
from .transpile import (PSArtifacts, PSTrainer, build_ps_programs,
                        launch_pservers)

__all__ = ["ParameterServer", "run_pserver", "PSClient", "wait_server_ready",
           "PSArtifacts", "PSTrainer", "build_ps_programs", "launch_pservers",
           "Communicator"]
