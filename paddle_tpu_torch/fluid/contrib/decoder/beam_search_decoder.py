"""Seq2seq decoder API (reference:
python/paddle/fluid/contrib/decoder/beam_search_decoder.py): InitState,
StateCell, TrainingDecoder and BeamSearchDecoder, the port of the JAX
package's ``fluid/contrib/decoder/beam_search_decoder.py``, building the
same programs op for op.

TrainingDecoder drives a StateCell through the port's DynamicRNN (one
``recurrent`` op, taped whole for its gradient). BeamSearchDecoder
unrolls ``max_len`` beam steps when the program is built: each step
scores the next tokens with the user's block (or, without a scorer, an fc
over the cell's out state), keeps ``topk_size`` of them, and prunes each
source's rows to ``beam_size`` with the ``beam_search`` op; ``decode``
stacks each step's selected ids and scores. As in the JAX package, the
search neither reads ``end_id`` nor reorders the states by parent, and
``decode()`` without a scorer makes a new fc at every step (ROADMAP
Queue 3)."""
from ... import layers

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]


class InitState(object):
    """Initial decoder state: an explicit tensor or a zeros boot state
    (reference beam_search_decoder.py InitState)."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError("init_boot must be provided when init is None")
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


class _DecoderType(object):
    TRAINING = 1
    BEAM_SEARCH = 2


class StateCell(object):
    """One decode step: named states + named inputs -> updated states
    (reference StateCell). The update function is registered with
    @state_updater and replayed inside whichever decoder drives the cell."""

    def __init__(self, inputs, states, out_state, name=None):
        self._inputs = dict(inputs)          # name -> placeholder/None
        self._init_states = dict(states)     # name -> InitState
        self._states = {}                    # live values inside a step
        self._out_state = out_state
        self._updater = None
        self._in_decoder = False

    def _enter_decoder(self, decoder_obj):
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj

    def _leave_decoder(self, decoder_obj):
        self._in_decoder = False
        self._cur_decoder_obj = None

    def state_updater(self, updater):
        """Decorator registering the step function (reference
        StateCell.state_updater)."""
        self._updater = updater

        def _decorator(state_cell):
            if state_cell is not self:
                raise ValueError("updater must update its own cell")
            updater(state_cell)
        return _decorator

    def get_state(self, state_name):
        if state_name not in self._states:
            raise KeyError("unknown state %r" % state_name)
        return self._states[state_name]

    def set_state(self, state_name, state_value):
        self._states[state_name] = state_value

    def get_input(self, input_name):
        if input_name not in self._inputs or self._inputs[input_name] is None:
            raise KeyError("input %r not set" % input_name)
        return self._inputs[input_name]

    def compute_state(self, inputs):
        """Run one step update with `inputs` (name -> value)."""
        for name, value in inputs.items():
            self._inputs[name] = value
        self._updater(self)

    def update_states(self):
        """Commit the step's states (the decoder reads them back as the
        next carry). The states are the step's Variables, so this is the
        read-back point, kept for the reference's API."""
        return dict(self._states)

    def out_state(self):
        return self._states[self._out_state]


class TrainingDecoder(object):
    """Teacher-forced decoding loop (reference TrainingDecoder): drives the
    StateCell over the target sequence with DynamicRNN."""

    def __init__(self, state_cell, name=None):
        self._state_cell = state_cell
        self._rnn = layers.DynamicRNN()
        self._in_block = False

    class _Guard(object):
        def __init__(self, d):
            self.d = d
            self.g = None

        def __enter__(self):
            self.d._in_block = True
            self.d._state_cell._enter_decoder(self.d)
            self.g = self.d._rnn.block()
            self.g.__enter__()
            # seed live states from the InitStates (memories in the rnn)
            for name, init in self.d._state_cell._init_states.items():
                mem = self.d._rnn.memory(init=init.value)
                self.d._state_cell._states[name] = mem
                self.d._state_cell._mem_of = getattr(
                    self.d._state_cell, "_mem_of", {})
                self.d._state_cell._mem_of[name] = mem
            return self.d

        def __exit__(self, *a):
            # route updated states back into the rnn memories
            for name, mem in self.d._state_cell._mem_of.items():
                self.d._rnn.update_memory(mem,
                                          self.d._state_cell._states[name])
            r = self.g.__exit__(*a)
            self.d._state_cell._leave_decoder(self.d)
            self.d._in_block = False
            return r

    def block(self):
        return TrainingDecoder._Guard(self)

    def step_input(self, x):
        if not self._in_block:
            raise RuntimeError("step_input only inside decoder.block()")
        return self._rnn.step_input(x)

    def static_input(self, x):
        if not self._in_block:
            raise RuntimeError("static_input only inside decoder.block()")
        return self._rnn.static_input(x)

    def output(self, *outputs):
        if not self._in_block:
            raise RuntimeError("output only inside decoder.block()")
        self._rnn.output(*outputs)

    def __call__(self, *args):
        return self._rnn(*args)


class BeamSearchDecoder(object):
    """Beam-search decoding loop (reference BeamSearchDecoder). The search
    is max_len steps unrolled into the program; each step scores candidates
    with the user block and prunes to beam_size with the beam_search op;
    ``decode`` returns every step's selected ids and scores, stacked."""

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict={}, topk_size=50, sparse_emb=True,
                 max_len=100, beam_size=1, end_id=1, name=None):
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict)
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._early = False
        self._in_block = False
        self._step_fn = None
        self._cur = {}

    class _Guard(object):
        """The user's block body is captured as a closure and replayed for
        every unrolled step: the reference's while block's surface."""

        def __init__(self, d):
            self.d = d

        def __enter__(self):
            self.d._in_block = True
            self.d._captured = []
            return self.d

        def __exit__(self, *a):
            self.d._in_block = False
            return False

    def block(self):
        return BeamSearchDecoder._Guard(self)

    def early_stop(self):
        """Mark the search as early-stoppable (bounded unroll already stops
        contributing once all beams emit end_id; kept for parity)."""
        self._early = True

    def read_array(self, init, is_ids=False, is_scores=False):
        if not self._in_block:
            raise RuntimeError("read_array only inside block()")
        # in the unrolled form the "array" is just the previous step's value
        return self._cur.setdefault(
            "prev_ids" if is_ids else ("prev_scores" if is_scores
                                       else id(init)), init)

    def update_array(self, array, value):
        for k, v in list(self._cur.items()):
            if v is array:
                self._cur[k] = value
                return
        self._cur[id(array)] = value

    def decode(self, step_fn=None):
        """Run the unrolled search. `step_fn(prev_ids, prev_scores, cell)
        -> (topk_scores_var, topk_indices_var)` scores the next tokens; when
        omitted, the cell's out_state is projected to the vocab with one fc
        (the reference's default scorer shape)."""
        self._step_fn = step_fn
        prev_ids = self._init_ids
        prev_scores = self._init_scores
        all_ids, all_scores = [], []
        cell = self._state_cell
        cell._states = {n: s.value for n, s in cell._init_states.items()}
        for step in range(self._max_len):
            if step_fn is not None:
                probs = step_fn(prev_ids, prev_scores, cell)
            else:
                cell.compute_state({"ids": prev_ids})
                probs = layers.fc(input=cell.out_state(),
                                  size=self._target_dict_dim, act="softmax")
            topk_scores, topk_indices = layers.topk(probs, k=self._topk_size)
            acc_scores = layers.elementwise_add(
                x=layers.log(topk_scores),
                y=layers.reshape(prev_scores, shape=[-1, 1]))
            sel = layers.beam_search(
                prev_ids, prev_scores, topk_indices, acc_scores,
                self._beam_size, self._end_id, return_parent_idx=False)
            sel_ids, sel_scores = sel[0], sel[1]
            all_ids.append(sel_ids)
            all_scores.append(sel_scores)
            prev_ids, prev_scores = sel_ids, sel_scores
        ids = layers.stack(all_ids, axis=1)
        scores = layers.stack(all_scores, axis=1)
        self._decoded = (ids, scores)
        return ids, scores

    def __call__(self):
        return self._decoded
