"""The contrib decoder classes: the port's copy of
``paddle_tpu/contrib/decoder/beam_search_decoder.py`` (reference
python/paddle/fluid/contrib/decoder/beam_search_decoder.py:523):
InitState / StateCell / TrainingDecoder / BeamSearchDecoder.

The reference builds a While op whose sub-block reads and writes LoD
tensor arrays and shrinks the live beam with LoD levels. As in the JAX
package, the training decoder rides DynamicRNN (dense [B, T, ...] with
length masking) and the beam decoder unrolls ``max_len`` steps of the
dense ``beam_search`` op into the program (the While form stays
available through layers.While and layers.beam_search)."""

from __future__ import annotations

import contextlib
from ... import layers
from ...layer_helper import LayerHelper


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState(object):
    """Initial state for a decoder cell (reference :43). Either an
    explicit `init` Variable or zeros of `shape` bootstrapped from
    `init_boot`'s batch dim."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "init_boot must be provided to infer the init batch size")
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class StateCell(object):
    """Carries decoder state between steps (reference :159): a dict of
    named states (InitState), a dict of named step inputs, and an
    updater function registered via @state_cell.state_updater."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper("state_cell", name=name)
        self._cur_states = {}
        self._state_names = []
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError("state must be an InitState object")
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = inputs  # inputs to state cell
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._states_holder = {}
        self._switched_decoder = False
        self._state_updater = None
        self._out_state = out_state

    def _enter_decoder(self, decoder_obj):
        if self._in_decoder or self._cur_decoder_obj is not None:
            raise ValueError("StateCell is already used in a decoder")
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder or self._cur_decoder_obj is not decoder_obj:
            raise ValueError("StateCell not in this decoder")
        self._in_decoder = False
        self._cur_decoder_obj = None

    def get_state(self, state_name):
        if state_name not in self._cur_states:
            raise ValueError(f"unknown state {state_name!r}")
        v = self._cur_states[state_name]
        return v.value if isinstance(v, InitState) else v

    def get_input(self, input_name):
        if input_name not in self._inputs or self._inputs[input_name] is None:
            raise ValueError(f"input variable {input_name!r} not found")
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell is not self:
                raise ValueError("updater must update its own cell")
            updater(state_cell)

        return _decorator

    def compute_state(self, inputs):
        """Run one step: bind step inputs, call the updater."""
        for name, value in inputs.items():
            if name not in self._inputs:
                raise ValueError(f"unknown input {name!r}")
            self._inputs[name] = value
        self._state_updater(self)

    def update_states(self):
        # dense representation: states are ordinary SSA values; the
        # enclosing DynamicRNN/unrolled loop carries them
        pass

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder(object):
    """Teacher-forced decoder (reference :384) over DynamicRNN: inside
    block(), split the target sequence with step_input, compute the
    cell step, emit with output()."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._helper = LayerHelper("training_decoder", name=name)
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = layers.DynamicRNN()
        self._type = _DecoderType.TRAINING
        self._outputs = []
        self._mem_link = []  # (state_name, drnn memory var)

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @contextlib.contextmanager
    def block(self):
        if self._status != TrainingDecoder.BEFORE_DECODER:
            raise ValueError("block() can only be invoked once")
        self._status = TrainingDecoder.IN_DECODER
        with self._dynamic_rnn.block():
            # materialize each state as a drnn memory so it carries
            # across time steps
            for name in self._state_cell._state_names:
                init = self._state_cell._cur_states[name]
                mem = self._dynamic_rnn.memory(init=init.value)
                self._state_cell.set_state(name, mem)
                self._mem_link.append((name, mem))
            yield
            for name, mem in self._mem_link:
                self._dynamic_rnn.update_memory(
                    mem, self._state_cell.get_state(name))
        self._status = TrainingDecoder.AFTER_DECODER
        self._state_cell._leave_decoder(self)

    def step_input(self, x):
        self._assert_in_decoder_block("step_input")
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_decoder_block("static_input")
        return self._dynamic_rnn.static_input(x)

    def output(self, *outputs):
        self._assert_in_decoder_block("output")
        self._outputs.extend(outputs)
        self._dynamic_rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError("call the decoder after its block")
        return self._dynamic_rnn(*args, **kwargs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError(f"{method} must be called in the decoder block")


class BeamSearchDecoder(object):
    """Inference beam search decoder (reference :523). decode() builds
    the default loop: embed prev ids -> state_cell step -> softmax over
    the target vocab -> dense beam_search expansion; __call__ returns
    (translation_ids, translation_scores) via beam_search_decode.

    `decode_step(decoder, prev_ids_emb) -> logits` may be passed to
    decode() to customize the projection (the reference exposes the
    same freedom through its block())."""

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict={}, topk_size=50, sparse_emb=True,
                 max_len=100, beam_size=1, end_id=1, name=None,
                 word_emb_param_name=None, proj_param_name=None,
                 proj_bias_param_name=None):
        self._helper = LayerHelper("beam_search_decoder", name=name)
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict)
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._word_emb_param_name = word_emb_param_name
        self._proj_param_name = proj_param_name
        self._proj_bias_param_name = proj_bias_param_name
        self._decoded = False
        self._translation = None

    def decode(self, decode_step=None):
        from ...param_attr import ParamAttr

        cell = self._state_cell
        ids = self._init_ids          # [B, beam] int64
        scores = self._init_scores    # [B, beam] float32
        step_ids, step_parents = [], []
        emb_attr = (ParamAttr(name=self._word_emb_param_name)
                    if self._word_emb_param_name else None)
        for t in range(self._max_len):
            flat = layers.reshape(ids, [-1, 1])  # [B*beam, 1]
            emb = layers.embedding(
                flat, size=[self._target_dict_dim, self._word_dim],
                param_attr=emb_attr, is_sparse=self._sparse_emb)
            emb = layers.reshape(emb, [-1, self._word_dim])
            if decode_step is not None:
                logits = decode_step(self, emb)
            else:
                cell.compute_state(inputs={"x": emb,
                                           **self._input_var_dict})
                logits = layers.fc(
                    cell.out_state(), self._target_dict_dim,
                    param_attr=(ParamAttr(name=self._proj_param_name)
                                if self._proj_param_name else None),
                    bias_attr=(ParamAttr(name=self._proj_bias_param_name)
                               if self._proj_bias_param_name else None))
                cell.update_states()
            probs = layers.softmax(logits)  # [B*beam, V]
            log_probs = layers.log(probs)
            acc = layers.elementwise_add(
                layers.reshape(log_probs,
                               [-1, self._beam_size, self._target_dict_dim]),
                layers.unsqueeze(scores, [2]))
            sel_ids, sel_scores, parents = layers.beam_search(
                ids, scores, None,
                layers.reshape(acc, [-1, self._beam_size,
                                     self._target_dict_dim]),
                self._beam_size, self._end_id, return_parent_idx=True)
            step_ids.append(layers.unsqueeze(sel_ids, [0]))
            step_parents.append(layers.unsqueeze(parents, [0]))
            # reorder every state by the parent beam before the next step
            for name in cell._state_names:
                state = cell.get_state(name)
                cell.set_state(name, _reorder_by_parent(
                    state, parents, self._beam_size))
            ids, scores = sel_ids, sel_scores
        all_ids = layers.concat(step_ids, axis=0)        # [T, B, beam]
        all_parents = layers.concat(step_parents, axis=0)
        self._translation = layers.beam_search_decode(
            all_ids, scores, self._beam_size, self._end_id,
            parents=all_parents, final_scores=scores)
        self._decoded = True
        self._state_cell._leave_decoder(self)

    def __call__(self):
        if not self._decoded:
            raise ValueError("call decode() before reading the translation")
        return self._translation


def _reorder_by_parent(state, parents, beam_size):
    """state [B*beam, H] gathered by parents [B, beam] within each
    batch row (the reference's array reorder by LoD parent index)."""
    H = state.shape[-1]
    grouped = layers.reshape(state, [-1, beam_size, H])
    picked = _row_gather(grouped, parents)
    return layers.reshape(picked, [-1, H])


def _row_gather(grouped, parents):
    """grouped [B, beam, H] indexed per-row by parents [B, beam]."""
    # one_hot over the beam dim, as the JAX package builds it:
    # out[b, j] = sum_k onehot[b, j, k] * g[b, k]
    oh = layers.one_hot(layers.unsqueeze(parents, [2]),
                        depth=grouped.shape[1])  # [B, beam, beam]
    return layers.matmul(oh, grouped)
