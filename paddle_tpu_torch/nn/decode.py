"""Sequence decoding (counterpart of ``paddle_tpu/nn/decode.py``): the
``Decoder`` protocol, ``BeamSearchDecoder`` and ``dynamic_decode``.

Each beam step is device work: ``log_softmax`` of the cell's logits in
f32, finished beams held to ``end_token`` at no cost, ``topk`` over
``beam * vocab`` per source, every cell state reordered by its parent
beam.  ``dynamic_decode`` is a host loop, as the reference's: it reads
``all(finished)`` back every step, and stops after ``max_step_num + 1``
steps when not every sequence has finished before.  ``finalize``
traces the beams back (``F.gather_tree``).  Cell states may be any
nesting of lists, tuples, namedtuples (the attention caches) and dicts
of tensors; ``impute_finished`` holds a finished entry's states where
they were.
"""
import collections

import torch

__all__ = ['Decoder', 'BeamSearchDecoder', 'dynamic_decode']


def _map(fn, *trees):
    """``fn`` over the tensors of equally nested structures."""
    t = trees[0]
    if torch.is_tensor(t):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, '_fields'):
        return type(t)(*(_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    return t


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return []


class Decoder:
    """The protocol ``dynamic_decode`` drives: ``initialize``, ``step``
    and (optionally) ``finalize``."""

    def initialize(self, inits):
        """-> (initial_inputs, initial_states, finished)."""
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        """-> (outputs, next_states, next_inputs, finished)."""
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over ``cell(inputs, states) -> (outputs,
    next_states)``; ``output_fn`` maps the cell's outputs to logits,
    ``embedding_fn`` token ids to the next inputs."""

    OutputWrapper = collections.namedtuple(
        'OutputWrapper', ('scores', 'predicted_ids', 'parent_ids'))
    StateWrapper = collections.namedtuple(
        'StateWrapper', ('cell_states', 'log_probs', 'finished', 'lengths'))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self._batch = None

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[B, ...]`` -> ``[B * beam, ...]``, each entry repeated
        ``beam_size`` times in a row."""
        return x.repeat_interleave(beam_size, dim=0)

    def _split(self, v):
        return v.reshape((self._batch, self.beam_size) + tuple(v.shape[1:]))

    def _merge(self, v):
        return v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))

    def initialize(self, initial_cell_states):
        first = _leaves(initial_cell_states)[0]
        self._batch = first.shape[0]
        B, K = self._batch, self.beam_size
        dev = first.device
        cell_states = _map(lambda t: self.tile_beam_merge_with_batch(t, K),
                           initial_cell_states)
        start = torch.full((B * K,), self.start_token, dtype=torch.long,
                           device=dev)
        inputs = self.embedding_fn(start) if self.embedding_fn else start
        # beam 0 live, the others at -inf: the first step expands one beam
        lp = torch.full((B, K), -float('inf'), dtype=torch.float32,
                        device=dev)
        lp[:, 0] = 0.0
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        lengths = torch.zeros((B, K), dtype=torch.long, device=dev)
        return inputs, self.StateWrapper(cell_states, lp, finished,
                                         lengths), finished

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_cell_states = self.cell(inputs, states.cell_states,
                                               **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        B, K = self._batch, self.beam_size
        logits = cell_out.float()
        V = logits.shape[-1]
        step_lp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        finished = states.finished
        # a finished beam may only emit end_token, at no cost
        only_end = torch.full((V,), -float('inf'), device=logits.device)
        only_end[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], only_end, step_lp)
        total = states.log_probs[..., None] + step_lp
        scores, top = torch.topk(total.reshape(B, K * V), K, dim=-1)
        parent = top // V
        token = top % V
        prev_fin = finished.gather(1, parent)
        next_fin = prev_fin | (token == self.end_token)
        lengths = states.lengths.gather(1, parent) + (~prev_fin).long()

        def reorder(t):
            v = self._split(t)
            idx = parent.reshape(parent.shape + (1,) * (v.dim() - 2))
            return self._merge(v.gather(1, idx.expand(
                (B, K) + tuple(v.shape[2:]))))

        next_cell_states = _map(reorder, next_cell_states)
        outputs = self.OutputWrapper(scores, token, parent)
        next_state = self.StateWrapper(next_cell_states, scores, next_fin,
                                       lengths)
        flat = token.reshape(B * K)
        next_inputs = self.embedding_fn(flat) if self.embedding_fn else flat
        return outputs, next_state, next_inputs, next_fin

    def finalize(self, outputs, final_states, sequence_lengths):
        """The beams traced back: predicted ids ``[T, B, beam]``."""
        from .functional import gather_tree
        return gather_tree(outputs.predicted_ids,
                           outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def _bmask(fin, new):
    """The ``[B(, K)]`` finished mask broadcast against a state leaf."""
    return fin.reshape(fin.shape + (1,) * (new.dim() - fin.dim()))


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every sequence finishes or ``max_step_num +
    1`` steps have run; returns ``(outputs, final_states)`` (and the
    sequence lengths with ``return_length``), outputs batch-major unless
    ``output_time_major``."""
    inputs, states, finished = decoder.initialize(inits)
    fin = finished
    seq_lengths = torch.zeros(fin.shape, dtype=torch.long, device=fin.device)
    collected = []
    step = 0
    while not bool(fin.all()):
        t = torch.tensor([step], dtype=torch.int32, device=fin.device)
        outputs, next_states, next_inputs, next_finished = \
            decoder.step(t, inputs, states, **kwargs)
        if not decoder.tracks_own_finished:
            nf = next_finished | fin
            seq_lengths = seq_lengths + (~fin).long()
            if impute_finished:     # a finished entry keeps its states
                next_states = _map(
                    lambda old, new: torch.where(_bmask(fin, new), old, new),
                    states, next_states)
            next_finished = nf
        else:
            seq_lengths = getattr(next_states, 'lengths', seq_lengths)
        collected.append(outputs)
        inputs, states = next_inputs, next_states
        fin = next_finished
        step += 1
        if max_step_num is not None and step > max_step_num:
            break
    stacked = _map(lambda *xs: torch.stack(xs, 0), *collected)
    final_states = states
    try:
        stacked, final_states = decoder.finalize(stacked, final_states,
                                                 seq_lengths)
    except NotImplementedError:
        pass
    if not output_time_major:
        stacked = _map(lambda x: x.movedim(0, 1), stacked)
    if return_length:
        return stacked, final_states, seq_lengths
    return stacked, final_states
