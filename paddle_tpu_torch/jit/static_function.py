"""`to_static` on the port (counterpart of
`paddle_tpu/jit/static_function.py`): a Paddle step function, imperative
code with ``loss.backward()`` and ``opt.step()`` inside, run as one
program a call.

The JAX package traces the step under ``jax.jit``; here the program is a
captured CUDA graph, and the protocol around it is the JAX package's:

1. Discovery. A signature's first call (and its first call with another
   ``.grad`` presence) runs the function eagerly with the read and write
   hooks of `core/tensor.py` installed. Every slot the run reads or
   rebinds that existed before it (a Tensor's value, an optimizer's
   accumulator or master copy, the generator's key chain) is the step's
   state; the parameters among them carry the ``.grad`` presence the
   program is kept for (the JAX package's ``mask_matches``). That run IS
   the call's step: call n performs exactly step n.
2. On the card the program's next ``EAGER_RUNS - 1`` calls run eagerly too,
   as real steps, on the device's capture stream
   (`inference/graphs.py::capture_stream`), so that lazy state and the
   stream's cuBLAS workspace exist outside the graph's pool. The call after
   them captures the step as one `inference/graphs.py::StepGraph` over
   static copies of its arguments, and every later call replays it: the
   arguments are copied into the static copies, each state slot that was
   rebound since (``paddle.seed``, ``set_state_dict``) is copied into the
   storage the graph reads, and the outputs are copied out of the graph's
   pool before they are returned. Inside the captured step every slot
   the step rebinds is copied back, at the end of the graph, into the
   storage it held on entry, which the next replay reads. A capture that
   fails raises; nothing falls back to an eager run.
3. On the CPU a hit runs the same state protocol without a graph: the
   function runs over the static copies of its arguments and every slot it
   rebinds is written back into the storage it held on entry.

While a step runs (eagerly, captured or on the CPU) `core.tensor.in_capture`
holds: the optimizer advances its step count on the device and reads the
rate from its rate tensor (`optimizer/optimizer.py::_lr_step`), the key
chain splits on the step's device, and a host read of a Tensor value
(``bool``, ``float``, ``item``, an index) raises
:class:`DataDependentControlFlowError`. The JAX package retries such a step
through its dy2static AST conversion; that is not ported (ROADMAP A10).

``multi_steps(k)`` runs the one-step program k times a call (on the card:
k replays of the one graph), over arguments with a leading axis of k, and
stacks the outputs on a leading axis of k.

Metrics (the port's `observability` registry, the JAX names):
``jit.cache_hit`` / ``jit.cache_miss`` a call, ``jit.compile_count`` and
``jit.compile_seconds`` a discovery, ``jit.dispatch_seconds`` a call's run,
``jit.donated_bytes`` the state a call updates in place, and the
``jit.capture:<name>`` span of each discovery.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import time
from typing import Any

import torch

from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.core import tensor as tensor_mod
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.inference import graphs
from paddle_tpu_torch.observability import metrics

__all__ = ["StaticFunction", "MultiStepFunction", "to_static",
           "not_to_static", "ignore_module", "DataDependentControlFlowError",
           "DataDependentIndexError", "EAGER_RUNS"]

_M_CACHE_HIT = metrics.counter("jit.cache_hit")
_M_CACHE_MISS = metrics.counter("jit.cache_miss")
_M_COMPILES = metrics.counter("jit.compile_count")
_M_COMPILE_S = metrics.histogram("jit.compile_seconds")
_M_DONATED = metrics.counter("jit.donated_bytes")
_M_DISPATCH_S = metrics.histogram("jit.dispatch_seconds")

# a program's calls that run eagerly on the card before it is captured
# (the first is its discovery): StepGraph's warm-up count, as real steps
EAGER_RUNS = graphs.WARMUP_RUNS

HINT = ("a Python branch, loop, index or host read depends on a Tensor "
        "value inside a to_static step. The JAX package converts such a "
        "step with its dy2static AST pass, which is not ported (ROADMAP "
        "A10): move the read out of the step, or use tensor ops "
        "(paddle.where) for the branch")


class DataDependentControlFlowError(RuntimeError):
    pass


class DataDependentIndexError(DataDependentControlFlowError, TypeError):
    """Raised from ``Tensor.__index__`` inside a step; a TypeError too, the
    index protocol's contract (as the JAX package's)."""


_IGNORED_MODULES: set = set()


def ignore_module(modules):
    _IGNORED_MODULES.update(modules)


def not_to_static(fn=None):
    if fn is None:
        return lambda f: f
    fn._not_to_static = True
    return fn


# ------------------------------------------------------------------ slots

def _get(holder, key):
    if isinstance(holder, dict):
        return holder.get(key)
    return getattr(holder, key, None)


def _set(holder, key, value):
    if isinstance(holder, dict):
        holder[key] = value
    else:
        setattr(holder, key, value)


def _grad(t):
    d = t._data
    return d.grad if d.is_leaf else None


def _slot_name(holder, key):
    if isinstance(holder, Tensor):
        return f"a Tensor of shape {holder.shape}" + (
            f" ({holder.name})" if holder.name else "")
    return f"{type(holder).__name__}[{key!r}]"


class _CaptureSet:
    """The state one run of a step touched: every slot that existed before
    the run, with its value when the run first touched it, and each
    parameter's ``.grad`` at its first touch. Tensors
    made during the run (its stamp is newer) and the run's arguments are
    not state; nor is a dict entry the run created."""

    def __init__(self, start_stamp: int, skip_ids=()):
        self.start = start_stamp
        self.skip = set(skip_ids)
        self.entry: dict = {}           # (id(holder), key) -> (holder, key, v)
        self.created: set = set()
        self.grads: dict = {}           # id(t) -> (t, .grad at first touch)

    def _slot(self, holder, key, write):
        if isinstance(holder, Tensor) and (id(holder) in self.skip
                                           or holder._stamp > self.start):
            return
        sk = (id(holder), key)
        if sk in self.created:
            return
        if sk not in self.entry:
            v = _get(holder, key)
            if v is None:
                if write:
                    self.created.add(sk)
                return
            self.entry[sk] = (holder, key, v)
            if isinstance(holder, Tensor) and v.is_leaf and v.requires_grad:
                self.grads[id(holder)] = (holder, v.grad)

    def on_read(self, holder, key):
        self._slot(holder, key, False)

    def on_write(self, holder, key):
        self._slot(holder, key, True)

    def rollback(self):
        """Rebind every slot to its value on entry (a failed run)."""
        for holder, key, v in self.entry.values():
            _set(holder, key, v)
        for t, g in self.grads.values():
            t._data.grad = g


@contextlib.contextmanager
def _hooked(cap):
    prev = tensor_mod.set_capture_hooks(cap.on_read, cap.on_write)
    prev_active = tensor_mod.set_capture_active(True)
    try:
        yield
    finally:
        tensor_mod.set_capture_hooks(*prev)
        tensor_mod.set_capture_active(prev_active)


@contextlib.contextmanager
def _on_capture_stream(dev):
    """An eager run of a step on the card: on the device's capture stream,
    in turn with every graph's capture and replay."""
    stream = graphs.capture_stream(dev)
    cur = torch.cuda.current_stream(dev)
    with graphs._CAPTURE_LOCK:
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            yield
        cur.wait_stream(stream)


def _tree_flatten_tensors(obj):
    """Flatten nested Python structures, extracting Tensors; returns
    (tensors, spec, rebuild)."""
    tensors = []

    def rec(o):
        if isinstance(o, Tensor):
            tensors.append(o)
            return ("__T__", len(tensors) - 1)
        if isinstance(o, dict):
            return {k: rec(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            items = [rec(v) for v in o]
            return ("__L__", type(o).__name__, items)
        return ("__C__", o)

    spec = rec(obj)

    def rebuild(spec, values, wrap):
        if isinstance(spec, tuple) and spec and spec[0] == "__T__":
            return wrap(values[spec[1]])
        if isinstance(spec, tuple) and spec and spec[0] == "__C__":
            return spec[1]
        if isinstance(spec, tuple) and spec and spec[0] == "__L__":
            seq = [rebuild(s, values, wrap) for s in spec[2]]
            return tuple(seq) if spec[1] == "tuple" else seq
        if isinstance(spec, dict):
            return {k: rebuild(v, values, wrap) for k, v in spec.items()}
        return spec

    return tensors, spec, rebuild


def _sig_of(args, kwargs):
    parts = []

    def rec(o):
        if isinstance(o, Tensor):
            parts.append(("T", tuple(o._data.shape), str(o.dtype),
                          o.stop_gradient, o._data.device.type))
        elif isinstance(o, (list, tuple)):
            parts.append(("L", len(o)))
            for v in o:
                rec(v)
        elif isinstance(o, dict):
            parts.append(("D", tuple(sorted(o))))
            for k in sorted(o):
                rec(o[k])
        else:
            parts.append(("C", repr(o)))

    rec(args)
    rec(kwargs)
    # a flag that changes what a step computes keys the program cache, or
    # setting it after the first capture would go unseen (the other two
    # of the JAX key, moe_dispatch and tpu_flash_impl, have one value here)
    from paddle_tpu_torch.framework.flags import flag_value
    parts.append(("F", flag_value("use_bfloat16_matmul")))
    return tuple(parts)


def _device_of(tensors):
    for t in tensors:
        return t._data.device
    return device_mod.current_device()


def _static_wrap(a, stop_gradient):
    t = Tensor(a, _internal=True)
    if not stop_gradient:
        t.stop_gradient = False
    return t


class _Program:
    """One variant of a step: its state slots, the ``.grad`` presence it
    is kept for, its outputs' structure, and on the card its graph."""

    def __init__(self, cap, out_spec, out_rebuild, out_stop_grads, device):
        self.device = device
        self.slots: dict = dict(cap.entry)
        self.leaves = [t for t, _ in cap.grads.values()]
        self.grad_mask = tuple(g is not None for _, g in cap.grads.values())
        self.exit_mask = self.presence()
        self.out_spec, self.out_rebuild = out_spec, out_rebuild
        self.out_stop_grads = out_stop_grads
        self.runs = 1
        self.static_args = None
        self.graph = None
        self.graph_seconds = None
        self.entry_grads = self.exit_grads = ()

    def presence(self):
        return tuple(_grad(t) is not None for t in self.leaves)

    def mask_matches(self):
        return self.grad_mask == self.presence()

    def merge(self, cap):
        for sk, v in cap.entry.items():
            self.slots.setdefault(sk, v)

    def state_bytes(self):
        n = 0
        for h, k, _ in self.slots.values():
            v = _get(h, k)
            if isinstance(v, torch.Tensor):
                n += v.numel() * v.element_size()
        for t in self.leaves:
            g = _grad(t)
            if g is not None:
                n += g.numel() * g.element_size()
        return n

    def wrap(self, arrays):
        wrapped = [Tensor(a, stop_gradient=sg, _internal=True)
                   for a, sg in zip(arrays, self.out_stop_grads)]
        return self.out_rebuild(self.out_spec, wrapped, lambda t: t)


def _outputs(result):
    return [t._data.detach() for t in _tree_flatten_tensors(result)[0]]


class StaticFunction:
    def __init__(self, function, input_spec=None, build_strategy=None,
                 backend=None, donate_state=None, **kwargs):
        self._fn = function
        self._cache: dict[Any, list] = {}
        self._input_spec = input_spec
        from paddle_tpu_torch.framework.flags import flag_value
        self._donate = flag_value("tpu_donate_buffers") \
            if donate_state is None else donate_state
        functools.update_wrapper(self, function)

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = functools.partial(self.__call__, instance)
        bound.__wrapped__ = self._fn
        return bound

    @property
    def code(self):
        return inspect.getsource(self._fn)

    @property
    def _name(self):
        return getattr(self._fn, "__name__", "?")

    def concrete_program(self, *args, **kwargs):
        """The newest program of the arguments' signature, or None."""
        variants = self._cache.get(_sig_of(args, kwargs))
        return variants[-1] if variants else None

    def __call__(self, *args, **kwargs):
        key = _sig_of(args, kwargs)
        prog = self._lookup(self._cache, key)
        dev = _device_of(_tree_flatten_tensors((args, kwargs))[0])
        if dev.type == "cuda":
            from paddle_tpu_torch.ops.random import default_generator
            default_generator().move_to(dev)
        t0 = time.perf_counter()
        if prog is None:
            _M_CACHE_MISS.inc()
            prog, outs = self._capture(key, args, kwargs, dev)
        else:
            _M_CACHE_HIT.inc()
            outs = self._run(prog, args, kwargs)
        _M_DISPATCH_S.observe(time.perf_counter() - t0)
        if self._donate:
            _M_DONATED.inc(prog.state_bytes())
        return prog.wrap(outs)

    @staticmethod
    def _lookup(cache, key):
        for cand in cache.get(key, ()):
            if cand.mask_matches():
                return cand
        return None

    # ------------------------------------------------------------ runs

    def _eager(self, args, kwargs, dev):
        """One eager run with the hooks on (on the card, on the capture
        stream): (its outputs, what it touched)."""
        arg_tensors = _tree_flatten_tensors((args, kwargs))[0]
        cap = _CaptureSet(tensor_mod.current_stamp(),
                          {id(t) for t in arg_tensors})
        try:
            with _hooked(cap), (_on_capture_stream(dev) if dev.type == "cuda"
                                else contextlib.nullcontext()):
                result = self._fn(*args, **kwargs)
        except BaseException:
            cap.rollback()
            raise
        return result, cap

    def _capture(self, key, args, kwargs, dev):
        """Discovery: the call's step, run eagerly, finds the program's
        state. Returns (the program, the step's outputs)."""
        t0 = time.perf_counter()
        result, cap = self._eager(args, kwargs, dev)
        out_tensors, out_spec, out_rebuild = _tree_flatten_tensors(result)
        prog = _Program(cap, out_spec, out_rebuild,
                        [t.stop_gradient for t in out_tensors], dev)
        self._cache.setdefault(key, []).append(prog)
        _M_COMPILES.inc()
        _M_COMPILE_S.observe(time.perf_counter() - t0)
        metrics.add_span(f"jit.capture:{self._name}", t0,
                         time.perf_counter() - t0, cat="compile")
        return prog, [t._data.detach() for t in out_tensors]

    def _run(self, prog, args, kwargs):
        """One step of a known program: eagerly while the card warms it,
        then captured and replayed; on the CPU the state protocol."""
        prog.runs += 1
        if prog.device.type != "cuda":
            return self._protocol(prog, args, kwargs)
        if prog.graph is None and prog.runs <= EAGER_RUNS:
            result, cap = self._eager(args, kwargs, prog.device)
            prog.merge(cap)
            return _outputs(result)
        if prog.graph is None:
            self._make_graph(prog, args, kwargs)
        return self._replay(prog, args, kwargs)

    def _protocol(self, prog, args, kwargs):
        """The step once over the program's static arguments: every slot
        it rebinds is copied back into the storage it held on entry, and so
        is each gradient it replaced. On the card this runs inside the
        capture; the copies are the graph's last kernels."""
        arg_tensors, spec, rebuild = _tree_flatten_tensors((args, kwargs))
        with torch.no_grad():
            if prog.static_args is None:
                prog.static_args = [t._data.detach().clone()
                                    for t in arg_tensors]
            elif prog.device.type != "cuda":
                for s, t in zip(prog.static_args, arg_tensors):
                    s.copy_(t._data)
        wrapped = [_static_wrap(s, t.stop_gradient)
                   for s, t in zip(prog.static_args, arg_tensors)]
        sargs, skwargs = rebuild(spec, wrapped, lambda t: t)
        cap = _CaptureSet(tensor_mod.current_stamp(),
                          {id(t) for t in wrapped})
        entry = {sk: (h, k, _get(h, k)) for sk, (h, k, _) in
                 prog.slots.items()}
        entry_grads = [(t, _grad(t)) for t in prog.leaves]
        try:
            with _hooked(cap):
                result = self._fn(*sargs, **skwargs)
            outs = _outputs(result)
            for sk, v in cap.entry.items():
                entry.setdefault(sk, v)
            seen = {id(t) for t in prog.leaves}
            entry_grads += [(t, g) for tid, (t, g) in cap.grads.items()
                            if tid not in seen]
            with torch.no_grad():
                for h, k, old in entry.values():
                    cur = _get(h, k)
                    if cur is old:
                        continue
                    if cur is None or cur.shape != old.shape or \
                            cur.dtype != old.dtype or \
                            cur.device != old.device:
                        raise RuntimeError(
                            f"to_static: the step {self._name} changed the "
                            f"shape, dtype or device of its state "
                            f"({_slot_name(h, k)}); a static step must "
                            "keep each state tensor's layout")
                    old.copy_(cur)
                    _set(h, k, old)
                for t, g0 in entry_grads:
                    g = _grad(t)
                    if g0 is not None and g is not None and g is not g0:
                        g0.copy_(g)
                        t._data.grad = g0
        except BaseException:
            for h, k, v in entry.values():
                _set(h, k, v)
            for t, g in entry_grads:
                t._data.grad = g
            raise
        prog.slots = entry
        prog.entry_grads = entry_grads
        prog.exit_grads = [(t, _grad(t)) for t, _ in entry_grads]
        return outs

    def _make_graph(self, prog, args, kwargs):
        """Capture the step on the card, over static copies of this call's
        arguments; the graph has not run when this returns."""
        t0 = time.perf_counter()
        prog.static_args = [t._data.detach().clone() for t in
                            _tree_flatten_tensors((args, kwargs))[0]]
        try:
            prog.graph = graphs.StepGraph(
                lambda: self._protocol(prog, args, kwargs), prog.device,
                warmup_runs=0)
        except Exception as e:
            prog.graph = prog.static_args = None
            raise RuntimeError(
                f"to_static: capturing the step {self._name} as a CUDA "
                f"graph failed ({type(e).__name__}: {e}); a step on the "
                "card must run without host reads or syncs") from e
        prog.graph_seconds = time.perf_counter() - t0

    def _replay(self, prog, args, kwargs):
        with torch.no_grad():
            for s, t in zip(prog.static_args,
                            _tree_flatten_tensors((args, kwargs))[0]):
                s.copy_(t._data)
            for h, k, v in prog.slots.values():
                cur = _get(h, k)
                if cur is not v:
                    v.copy_(cur)
                    _set(h, k, v)
            for t, g in prog.entry_grads:
                cur = _grad(t)
                if g is not None and cur is not g:
                    g.copy_(cur)
                    t._data.grad = g
        outs = prog.graph()
        for t, g in prog.exit_grads:
            t._data.grad = g
        return [o.clone() for o in outs]

    def multi_steps(self, k: int) -> "MultiStepFunction":
        """k steps a call: the returned callable takes the step's arguments
        with an extra leading axis of size k (one slice a step), runs the
        one-step program k times (on the card: k replays of its graph),
        and returns the outputs stacked on a leading axis of k. Host code
        between steps (``lr_scheduler.step()``) runs between calls, so the
        rate is constant within one call. The step must leave ``.grad``
        presence as it found it (a full train step ending in
        ``clear_grad()``)."""
        return MultiStepFunction(self, k)


class MultiStepFunction:
    """See StaticFunction.multi_steps. Shares the step's programs with the
    parent StaticFunction; its own cache maps signatures to them."""

    def __init__(self, static_fn: StaticFunction, k: int):
        if int(k) < 1:
            raise ValueError(f"multi_steps k must be >= 1, got {k}")
        self._sf = static_fn
        self._k = int(k)
        self._cache: dict[Any, list] = {}
        functools.update_wrapper(self, static_fn._fn)

    @property
    def steps_per_call(self):
        return self._k

    def __call__(self, *args, **kwargs):
        k = self._k
        arg_tensors, arg_spec, rebuild = _tree_flatten_tensors((args, kwargs))
        for t in arg_tensors:
            if not t._data.shape or t._data.shape[0] != k:
                raise ValueError(
                    f"multi_steps({k}): every tensor argument needs a leading "
                    f"axis of size {k} (one slice per step); got shape "
                    f"{tuple(t._data.shape)}")

        def step_args(i):
            ts = [Tensor(t._data[i], stop_gradient=t.stop_gradient,
                         _internal=True) for t in arg_tensors]
            return rebuild(arg_spec, ts, lambda t: t)

        sa, sk = step_args(0)
        sig = _sig_of(sa, sk)
        sf = self._sf
        dev = _device_of(arg_tensors)
        if dev.type == "cuda":
            from paddle_tpu_torch.ops.random import default_generator
            default_generator().move_to(dev)
        t0 = time.perf_counter()
        prog = sf._lookup(self._cache, sig)
        per_step = []
        if prog is None:
            _M_CACHE_MISS.inc()
            prog = sf._lookup(sf._cache, sig)
            if prog is None:
                prog, outs = sf._capture(sig, sa, sk, dev)
                per_step.append(outs)
            self._cache.setdefault(sig, []).append(prog)
        else:
            _M_CACHE_HIT.inc()
        for i in range(len(per_step), k):
            if prog.exit_mask != prog.grad_mask or not prog.mask_matches():
                raise TypeError(
                    "multi_steps: the step changes which tensors carry a "
                    ".grad between entry and exit. Use multi_steps only on "
                    "full train steps that end in clear_grad(); run "
                    "grad-accumulation micro-steps through the plain "
                    "to_static path.")
            per_step.append(sf._run(prog, *step_args(i)))
        stacked = [torch.stack([o[j] for o in per_step])
                   for j in range(len(per_step[0]))]
        _M_DISPATCH_S.observe(time.perf_counter() - t0)
        if sf._donate:
            _M_DONATED.inc(prog.state_bytes())
        return prog.wrap(stacked)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator/wrapper running imperative code as one program a call (a
    captured CUDA graph on the card); a Layer gets a static forward."""
    def decorate(fn):
        if isinstance(fn, StaticFunction):
            return fn
        from paddle_tpu_torch.nn.layer import Layer
        if isinstance(fn, Layer):
            layer = fn
            layer.forward = StaticFunction(layer.forward.__func__).__get__(
                layer, type(layer))
            return layer
        return StaticFunction(fn, input_spec=input_spec,
                              build_strategy=build_strategy, backend=backend,
                              **kwargs)

    if function is not None:
        return decorate(function)
    return decorate
