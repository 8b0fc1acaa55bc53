"""Each decode dispatch on the card as a replayed CUDA graph.

In the JAX engine a dispatch of N decode steps is one compiled program
(`_decode_multi_core`, engine.py:422-450, and the speculative multi-step
cores). PyTorch's counterpart is a CUDA graph: the engine's decode step
(runtime/engine.py `decode_step`, or the speculative steps) is captured
once per variant and replayed N times a dispatch, with no host wait
between replays. A variant is one set of the host branches the step takes:
plain, prompt-lookup or draft speculation, penalties or not, any sampled
slot or not, the window K, the draft tail, #3's int8-dot switch
(DPT_ATTN_INT8, which JAX reads at trace time), whether a slot is guided
(only then does the step read the structured-output tables) and the
top-k width (`emit_top_logprobs`, whose values and ids the step writes
into the dispatch's output rows). `StepGraphs` keeps one
graph a variant for one engine, all in one memory pool.

What a graph needs of the step it captures:
- every tensor it reads or writes stays where it is: the decode state, the
  caches (contiguous, paged, stacked, the kt mirror, the draft's), the
  prompt-lookup history, the page table and the dispatch's output rows are
  updated in place, never rebound; the guide tables are rebuilt when a
  guide registers, and the engine then drops the guided variants
  (`drop`), which are captured anew;
- nothing reads the device back (the sampling draw is a Gumbel-max, the
  host branches are the variant's);
- its random numbers come from the engine's generator, registered with
  the graph, so that each replay draws anew.

Before the first capture of a variant the step runs once eagerly on
clones of the state and the history (the caches are the engine's: the
step writes the rows the replay writes next, with the same bytes), so
that the kernel library is loaded and every kernel's attributes are set
outside the capture; the generator's state is put back after it. A
variant that fails to capture or to replay raises, naming it: nothing
falls back to the eager step.

The Python launch counters of the kernel wrappers (`fn.launches`,
`fn.variant_launches`) count calls, so the warm-up and the capture would
count launches that never served a request, and the replays none. They
are put back after a capture, and each replay adds what its capture
recorded.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.kernels import (decode_attention, dequant_matmul,
                           flash_attention, grouped_matmul, kv_append)

#: every kernel wrapper that keeps a launch count
COUNTED = (dequant_matmul.dequant_matmul,
           dequant_matmul.quantize_activations,
           dequant_matmul.stage_activations,
           decode_attention.decode_attention,
           decode_attention.decode_attention_paged,
           decode_attention.decode_attention_kt,
           decode_attention.decode_attention_kernel,
           kv_append.scatter_rows, kv_append.scatter_rows_stacked,
           kv_append.scatter_pool_rows,
           grouped_matmul.grouped_dequant_matmul,
           grouped_matmul.grouped_dequant_matmul_ncat,
           grouped_matmul.quantize_segments,
           flash_attention.flash_attention_prefill,
           flash_attention.flash_attention_chunk)

Counts = List[Tuple[int, collections.Counter]]


def counts() -> Counts:
    """A copy of every wrapper's launch counts."""
    return [(fn.launches,
             collections.Counter(getattr(fn, "variant_launches", {})))
            for fn in COUNTED]


def restore(saved: Counts) -> None:
    """Put the launch counts back to `saved`, in the same objects."""
    for fn, (n, per) in zip(COUNTED, saved):
        fn.launches = n
        if hasattr(fn, "variant_launches"):
            fn.variant_launches.clear()
            fn.variant_launches.update(per)


def _delta(after: Counts, before: Counts) -> Counts:
    return [(a - b, pa - pb) for (a, pa), (b, pb) in zip(after, before)]


def add(delta: Counts) -> None:
    """Count one replay: add what its capture recorded."""
    for fn, (n, per) in zip(COUNTED, delta):
        if n:
            fn.launches += n
        if per:
            for key, v in per.items():
                fn.variant_launches[key] += v


class StepGraphs:
    """The captured decode steps of one engine: {variant: (graph, the
    launch counts one replay stands for)}, one memory pool for all."""

    def __init__(self, generator: torch.Generator):
        self._generator = generator
        self._graphs: Dict[tuple, Tuple[torch.cuda.CUDAGraph, Counts]] = {}
        self._pool = None
        #: seconds spent warming up and capturing, over every variant
        self.capture_s = 0.0

    @property
    def variants(self) -> List[tuple]:
        return list(self._graphs)

    def pool_bytes(self) -> Optional[int]:
        """Device bytes the graphs' pool holds (from the allocator's
        snapshot; None where its segments do not name their pool)."""
        if self._pool is None:
            return 0
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" not in segs[0]:
            return None
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == pool)

    def drop(self, which: Callable[[tuple], bool]) -> List[tuple]:
        """Drop the captured variants whose key `which` accepts (they read
        tensors that were replaced, such as the guide tables) after the
        work queued on the card, which may be replaying them, has ended;
        they are captured anew at their next use. Returns their keys."""
        gone = [k for k in self._graphs if which(k)]
        if gone:
            torch.cuda.current_stream().synchronize()
            for k in gone:
                del self._graphs[k]
        return gone

    def replay(self, key: tuple, step: Callable[[], None],
               warm: Callable[[], None], n: int = 1) -> None:
        """Replay variant `key` n times on the current stream, capturing
        `step` first if it has no graph yet (after one `warm` run)."""
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key, step, warm)
        graph, delta = entry
        try:
            for _ in range(n):
                graph.replay()
                add(delta)
        except Exception as e:
            raise RuntimeError(
                f"decode step variant {key} failed to replay: {e}") from e

    def _capture(self, key, step, warm):
        t0 = time.perf_counter()
        saved = counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        rng = self._generator.get_state()
        try:
            with torch.no_grad(), torch.cuda.stream(side):
                warm()
            torch.cuda.current_stream().wait_stream(side)
            self._generator.set_state(rng)
            before = counts()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self._generator)
            # thread_local: a capture in the scheduler's thread is not
            # broken by what another thread does on the card meanwhile
            with torch.no_grad(), torch.cuda.graph(
                    graph, pool=self._pool, stream=side,
                    capture_error_mode="thread_local"):
                step()
            delta = _delta(counts(), before)
        except Exception as e:
            raise RuntimeError(
                f"decode step variant {key} failed to capture: {e}") from e
        finally:
            restore(saved)
        if self._pool is None:
            self._pool = graph.pool()
        self.capture_s += time.perf_counter() - t0
        return graph, delta
