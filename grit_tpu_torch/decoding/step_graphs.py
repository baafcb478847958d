"""The caption decode step replayed from CUDA graphs.

One step of ``CaptionGenerator.decode_step`` is ~120 small launches (the
embedding, each layer's self-attention and cache writes, K11's tails, the
vocab head, the log-softmax); at beam 5 x b128 its device work is ~2 ms and
the host's Python between the ops sets the pace.  ``StepGraphs`` captures the
step once per step index ``t`` and replays it:

- the step bakes ``t`` in as a Python int (the position row, the pad-history
  column, the cache slot), so each ``t`` has its own graph, captured at its
  first use: the step runs once eagerly on the graph's buffers (the warm-up:
  library builds, handles, one-time attributes; its output is that call's),
  then under capture, which launches nothing.  What the step does is fixed
  then: a function patched later does not reach it;
- a *set* of graphs is keyed on what the step observes in its inputs: the
  shapes, dtypes and devices of the token, the caches, the visual inputs and
  their projected K/V, ``vis_fold``, and whether inference mode is on.  At
  most ``MAX_SETS`` sets are kept (the least recently used is dropped), and
  every graph of one ``StepGraphs`` shares one memory pool;
- a set holds the buffers its graphs read: the visual inputs and K/V,
  copied at step 0 of each search (and when the set is new); the token and
  the cache leaves, copied at every step (``beam_search`` hands back new,
  reordered caches), which the step updates in place; and the log-probs,
  which every graph of the set writes;
- the log-probs and the cache returned are the set's buffers, valid until
  the next step of this ``StepGraphs``: the caller consumes them first, as
  ``beam_search`` does (it scores the log-probs and reorders the cache into
  tensors of its own).  The graphs read the model's parameters where they
  lie: update them in place (an optimizer step, ``load_state_dict``), never
  by re-binding their storage;
- a replay runs no Python, so the ops modules' launch counters (``LAUNCHES``)
  would not see it: each graph's counter deltas over its capture are taken
  back after the capture and added at every replay, so that the counters
  read what the eager step would.  A replay runs inside the
  ``grit.decode_graph`` span.

``CudaGraphs`` does the capturing; a stand-in with the same three members
(``device_type``, ``warm_up``, ``capture``) drives the bookkeeping on the
CPU in the tests.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from grit_tpu_torch.decoding.beam_search import _leaves, _map_tree
from grit_tpu_torch.utils.misc import trace_annotation

#: sets of graphs kept for one generator (one a shape of inputs)
MAX_SETS = 4


def _signature(tree) -> tuple:
    return tuple((tuple(x.shape), x.dtype, x.device) for x in _leaves(tree))


def _copy(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


def _counters() -> list[dict]:
    """The ``LAUNCHES`` dicts of the ops modules."""
    from grit_tpu_torch.ops import decode_layer, fused_adam, lsa, moe, msda
    from grit_tpu_torch.ops import window_attention

    return [m.LAUNCHES for m in (decode_layer, fused_adam, lsa, moe, msda, window_attention)]


class CudaGraphs:
    """Captures into CUDA graphs on one side stream and one memory pool (a
    stream and a pool a device)."""

    device_type = "cuda"

    def __init__(self):
        self._places: dict = {}

    def _place(self, device):
        if device not in self._places:
            self._places[device] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
        return self._places[device]

    def warm_up(self, fn, device) -> None:
        """Run ``fn`` once on the capture stream of ``device``."""
        _, stream = self._place(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream(device).wait_stream(stream)

    def capture(self, fn, device) -> torch.cuda.CUDAGraph:
        """``fn``'s launches on ``device`` as a graph, ``replay()`` to run
        them.  Other threads may use the device meanwhile (``thread_local``):
        a caller's thread that waits on a finished batch's event is no
        fault."""
        pool, stream = self._place(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            fn()
        return graph


class _Set:
    """The buffers and graphs of one shape of inputs."""

    def __init__(self, token, vis, vis_kv, cache, vocab: int):
        self.token, self.vis, self.cache = _map_tree(torch.empty_like, (token, vis, cache))
        self.vis_kv = None if vis_kv is None else _map_tree(torch.empty_like, vis_kv)
        self.log_probs = torch.empty((token.shape[0], vocab), device=token.device)
        self.graphs: dict = {}   # t -> (graph, [(counters, key, launches a replay)])


class StepGraphs:
    """One generator's decode-step graphs (module docstring).  ``graphs``:
    what captures them, ``CudaGraphs()`` by default."""

    def __init__(self, graphs=None):
        self.graphs = graphs if graphs is not None else CudaGraphs()
        self.sets: OrderedDict = OrderedDict()

    @property
    def device_type(self) -> str:
        return self.graphs.device_type

    def __call__(self, step, token, t: int, vis: dict, cache, vis_kv, vis_fold: int,
                 vocab: int):
        """``step(token, t, vis, cache, vis_kv=, vis_fold=, out=)`` -> (log-probs
        [B, vocab] f32, cache), replayed from this set's graph of step ``t``."""
        key = (vis_fold, torch.is_inference_mode_enabled(), vis_kv is None,
               _signature((token, cache, vis, vis_kv)))
        s = self.sets.pop(key, None)
        fresh = s is None
        if fresh:
            if len(self.sets) >= MAX_SETS:
                self.sets.popitem(last=False)
            s = _Set(token, vis, vis_kv, cache, vocab)
        self.sets[key] = s
        if fresh or t == 0:
            _copy((s.vis, s.vis_kv), (vis, vis_kv))
        _copy((s.token, s.cache), (token, cache))
        if t in s.graphs:
            graph, per_replay = s.graphs[t]
            with trace_annotation("grit.decode_graph"):
                graph.replay()
            for counters, name, n in per_replay:
                counters[name] += n
        else:   # the capture's warm-up computed this step
            s.graphs[t] = self._capture(s, step, t, vis_fold)
        return s.log_probs, s.cache

    def _capture(self, s: _Set, step, t: int, vis_fold: int):
        def run():
            step(s.token, t, s.vis, s.cache, vis_kv=s.vis_kv, vis_fold=vis_fold, out=s.log_probs)

        self.graphs.warm_up(run, s.token.device)
        before = [dict(c) for c in _counters()]
        graph = self.graphs.capture(run, s.token.device)
        per_replay = [(c, k, c[k] - b.get(k, 0)) for c, b in zip(_counters(), before)
                      for k in c if c[k] != b.get(k, 0)]
        for counters, name, n in per_replay:   # the capture launched nothing
            counters[name] -= n
        return graph, per_replay
