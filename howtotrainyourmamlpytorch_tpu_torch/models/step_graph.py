"""The meta-update as a CUDA graph, replayed K times a dispatch: the card's
form of the JAX package's jitted ``_train_step`` and of the ``lax.scan``
over it in ``run_train_iters``
(``howtotrainyourmamlpytorch_tpu/models/maml.py:373-402``).

``MAMLFewShotLearner._train_step`` is captured once per program variant
(second order, MSL final-only) and batch shape and dtype into static input
and output buffers; a bfloat16 learner's step is a graph of its own. A replay is one ``cudaGraphLaunch`` in place of the
step's thousands of launches from Python and autograd; any K, an epoch's
shorter last chunk included, replays the same graph, and device memory
stays one step's peak.

What a replay reads is written into the static inputs before it, on the
caller's stream and without a host synchronisation:

* the state: copied in at the start of a dispatch
  (``torch._foreach_copy_``), and from the step's outputs between
  replays. The caller's tensors are read, never written;
* the learning rate: ``fill_`` of the captured state's scalar, so the
  cosine schedule moves at each epoch although capture saw one value;
* the MSL importance vector: copied from a page-locked host tensor when
  it changes;
* slot k of the dispatch group: a device-to-device copy of each of its
  fields, the on-device augmentation's operand (a fifth field) included.

What a replay writes, the next one overwrites. So each replay's loss,
accuracy and non-finite flag are copied into slot k of a fresh ``(3, K)``
tensor, and the state a dispatch returns is a copy of the outputs.

Before capture the step runs once eagerly on the capture's stream:
cuDNN builds its convolution plans, the fused-norm wrappers query their
launch plans, and the allocator and the libraries' workspaces warm up on
that stream, none of which may happen inside a capture. The context
managers of ``warmup_hooks`` are entered around that warm-up, once a
capture (the program ledger counts its FLOPs there, ``telemetry/device.py``;
the capture guard of ``utils/sanitize.py`` counts captures there). A
capture that fails raises; nothing runs the eager step in its place.

The capture runs under ``collector_paused``: Python's cyclic garbage
collector may otherwise run on the capturing thread and finalize what an
earlier run left in a reference cycle (a learner's step graphs), and
destroying a graph there ends the capture with
``cudaErrorStreamCaptureInvalidated`` (``tools/port_capture_probe.py``).

The fused-norm wrappers run at capture, not on replay: their
``launch_counts`` see a step once. Each graph keeps the launches it
captured (``launches``, per replay), its number of ``replays`` and the
seconds its warm-up and capture took (``capture_s``). The captured
``cudaGraph_t`` is kept beside its executable (``keep_graph``), so the
kernel nodes a replay launches can be read back from it
(``graph.raw_cuda_graph()``). Each capture emits a ``capture`` event
(the program ledger's name and signature, ``capture_s``, the launches):
the port's counterpart of the JAX package's compile events.

On a learner of ``dp`` > 1 ranks the step is split at the reduction seam,
because the all-reduce of a gloo group runs on the host and cannot sit
inside a capture: graph A computes the rank's meta-gradient parts
(``_meta_grads_local``) into one static flat buffer per dtype
(``parallel/collectives.flatten_buckets``); the buffers are all-reduced
in place between the replays; graph B runs Adam and the sentinel
(``_apply_meta_update``) from them. A dispatch of K runs K times A, the
reduction, B. The launches each graph captured are kept per graph
(``part_launches``); ``launches`` is their sum, and ``reduce_s`` the host
seconds the reductions took, which each dispatch also emits as a
``reduce`` event (its seconds, its K and the bytes a rank reduces a
step). One rank's step stays one graph.

On a tensor-parallel learner (``mp`` > 1) nothing is captured: the card
runs the eager step (``MAMLFewShotLearner._train_group``). Its
collectives sit inside the forward and both backward passes, and on gloo
each goes through the host, which no capture can hold; NCCL, which could
be captured, refuses two ranks on one card. A captured tensor-parallel
step over NCCL, one card a rank, waits for a cell of more than one card.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from ..ops import fused_norm
from ..parallel.collectives import all_reduce_, flatten_buckets, unflatten_buckets
from ..telemetry import events as telemetry_events
from ..telemetry.device import program_name, program_signature
from ..utils.trees import tree_leaves, tree_map, tree_unflatten

#: Eager steps on the capture's stream before the capture.
WARMUP_STEPS = 1

#: Factories ``hook(key, steps)`` of context managers entered around the
#: warm-up of every capture; ``key`` is the graph's ``(second_order,
#: final_only, ((shape, dtype), ...))``.
warmup_hooks: list = []


@contextlib.contextmanager
def collector_paused():
    """Keeps Python's cyclic garbage collector off for the block, so that
    no finalizer runs on this thread inside a capture; what is garbage by
    then is collected at the first collection after it."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """One captured ``_train_step`` with its static buffers."""

    def __init__(self, learner, state, batch, importance: np.ndarray, lr: float,
                 *, second_order: bool, final_only: bool, stream, key=None):
        t0 = time.perf_counter()
        device = batch[0].device
        self.key = (second_order, final_only)
        self._inputs = tree_map(torch.empty_like, state)
        self._in_leaves = tree_leaves(self._inputs)
        self._lr = self._inputs.opt_state.learning_rate
        self._batch = tuple(torch.empty_like(a) for a in batch)
        self._importance = torch.empty(
            len(importance), dtype=torch.float32, device=device
        )
        self._host_importance = None
        self._load(state, importance, lr)
        for dst, src in zip(self._batch, batch):
            dst.copy_(src)

        branch = dict(second_order=second_order, final_only=final_only)

        def step():
            return learner._train_step(
                self._inputs, self._batch, self._importance, **branch
            )

        def grads_part():
            """Graph A: the rank's parts, into one flat buffer per dtype."""
            return flatten_buckets(learner._meta_grads_local(
                self._inputs, self._batch, self._importance, **branch
            ))

        def update_part(buckets, spec):
            """Graph B: the update from the reduced buffers."""
            new_state, metrics = learner._apply_meta_update(
                self._inputs, unflatten_buckets(buckets, spec)
            )
            return new_state, torch.stack(
                [metrics["loss"], metrics["accuracy"], metrics["nonfinite"]]
            )

        self.split = learner.dp > 1
        self.reduce_s = 0.0
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream), contextlib.ExitStack() as hooks:
            for hook in list(warmup_hooks):
                hooks.enter_context(hook(key, WARMUP_STEPS))
            for _ in range(WARMUP_STEPS):
                if self.split:
                    # Every rank warms up in step, the reduction included.
                    buckets, spec = grads_part()
                    self._reduce(buckets)
                    update_part(buckets, spec)
                else:
                    step()
        current.wait_stream(stream)

        def capture(fn, *args):
            """``fn`` captured into a new graph: ``(graph, its outputs, the
            launches it recorded)``."""
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = dict(fused_norm.launch_counts)
            # thread_local: the prefetcher's thread may pin host memory and
            # copy on its own stream while this thread captures.
            with collector_paused(), torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"
            ):
                out = fn(*args)
            graph.instantiate()
            return graph, out, {
                name: fused_norm.launch_counts[name] - before[name] for name in before
            }

        if self.split:
            self.graph, (self._buckets, spec), grads_launches = capture(grads_part)
            self.update_graph, (self._outputs, self._metrics), update_launches = capture(
                update_part, self._buckets, spec
            )
            self.part_launches = {"meta_grads": grads_launches,
                                  "update": update_launches}
        else:
            def whole():
                new_state, metrics = step()
                return new_state, torch.stack(
                    [metrics["loss"], metrics["accuracy"], metrics["nonfinite"]]
                )

            self.graph, (self._outputs, self._metrics), launches = capture(whole)
            self.update_graph = None
            self.part_launches = {"step": launches}
        self.launches = {
            name: sum(part[name] for part in self.part_launches.values())
            for name in fused_norm.launch_counts
        }
        self.replays = 0
        out_leaves = tree_leaves(self._outputs)
        # Outputs that are the inputs themselves (frozen leaves, the
        # learning rate) carry over by themselves.
        carried = [
            (i, o) for i, o in zip(self._in_leaves, out_leaves)
            if i.data_ptr() != o.data_ptr()
        ]
        self._carry_in = [i for i, _ in carried]
        self._carry_out = [o for _, o in carried]
        self._out_leaves = out_leaves
        # Host seconds of the warm-up and the capture (entering the capture
        # synchronizes the device, so the warm-up's device time is in it).
        self.capture_s = time.perf_counter() - t0

    def _reduce(self, buckets: dict) -> None:
        """The all-reduce of the flat buffers, in place. The host first
        waits for the work queued before it (graph A), which a reduction
        through the host would wait for anyway, so that ``reduce_s`` times
        the reduction alone (and the wait for the slowest rank)."""
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        for buf in buckets.values():
            all_reduce_(buf)
        self.reduce_s += time.perf_counter() - t0

    def _load(self, state, importance: np.ndarray, lr: float) -> None:
        """The caller's state, the epoch's learning rate and importance
        vector into the static inputs, on the current stream."""
        torch._foreach_copy_(self._in_leaves, tree_leaves(state))
        self._lr.fill_(lr)
        if self._host_importance is None or not np.array_equal(
            self._host_importance, importance
        ):
            host = torch.from_numpy(np.asarray(importance, np.float32)).pin_memory()
            self._importance.copy_(host, non_blocking=True)
            self._host_importance = np.array(importance, np.float32)

    def dispatch(self, state, group, importance: np.ndarray, lr: float):
        """``len(group[0])`` meta-updates from ``state``; ``group`` holds
        the batch fields with a leading K axis, on the device. Returns
        ``(new_state, (3, K) metrics)``: loss, accuracy, nonfinite rows."""
        k_total = group[0].shape[0]
        self._load(state, importance, lr)
        metrics = torch.empty(
            (3, k_total), dtype=torch.float32, device=self._lr.device
        )
        for k in range(k_total):
            if k:
                torch._foreach_copy_(self._carry_in, self._carry_out)
            for dst, src in zip(self._batch, group):
                dst.copy_(src[k])
            self.graph.replay()
            if self.split:
                self._reduce(self._buckets)
                self.update_graph.replay()
            self.replays += 1
            metrics[:, k].copy_(self._metrics)
        fresh = [torch.empty_like(a) for a in self._out_leaves]
        torch._foreach_copy_(fresh, self._out_leaves)
        return tree_unflatten(self._outputs, fresh), metrics


class StepGraphs:
    """A learner's captured steps, one per ``(second_order, final_only)``
    branch and batch shape, sharing one capture stream."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.graphs: dict[tuple, StepGraph] = {}

    def run(self, learner, state, group, importance: np.ndarray, lr: float,
            *, second_order: bool, final_only: bool):
        """``StepGraph.dispatch`` on the graph of this branch and batch
        shape, captured at its first dispatch."""
        key = (second_order, final_only,
               tuple((tuple(a.shape[1:]), a.dtype) for a in group))
        graph = self.graphs.get(key)
        if graph is None:
            graph = StepGraph(
                learner, state, tuple(a[0] for a in group), importance, lr,
                second_order=second_order, final_only=final_only,
                stream=self.stream, key=key,
            )
            self.graphs[key] = graph
            telemetry_events.emit(
                "capture", name=program_name(second_order, final_only),
                signature=program_signature(key[2]), capture_s=graph.capture_s,
                launches=dict(graph.launches),
            )
        if not graph.split:
            return graph.dispatch(state, group, importance, lr)
        before = graph.reduce_s
        out = graph.dispatch(state, group, importance, lr)
        telemetry_events.emit(
            "reduce", name=program_name(second_order, final_only),
            k=int(group[0].shape[0]), reduce_s=graph.reduce_s - before,
            bytes=sum(b.numel() * b.element_size() for b in graph._buckets.values()),
        )
        return out
