"""% of the traced window's rollouter calls (host intervals of the
program's span ``slotformer.rollouter``) that ran as one CUDA graph: that
hold a host interval of ``slotformer.rollouter.graph``, the span around
the graph's replay. Its own pass over the window's events; a program
without the replay span reads None."""

from torch.autograd import DeviceType

CALL, REPLAY = "slotformer.rollouter", "slotformer.rollouter.graph"


def read(ctx):
    if getattr(ctx, "trace", None) is None:
        return None
    w0, w1 = ctx.trace.window_ns
    host = {CALL: [], REPLAY: []}
    for e in ctx.window.prof.profiler.kineto_results.events():
        name = e.name()
        if name in host and e.device_type() != DeviceType.CUDA:
            s = e.start_ns()
            host[name].append((s, s + e.duration_ns()))
    calls = [(s, e) for s, e in host[CALL] if e > w0 and s < w1]
    if not calls or not host[REPLAY]:
        return None
    held = sum(any(s <= a and b <= e for a, b in host[REPLAY])
               for s, e in calls)
    return 100.0 * held / len(calls)
