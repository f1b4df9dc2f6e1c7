"""Device milliseconds a step of the operations the port's column draws
launched (``product.draw`` spans in ``ops/product.py``: the row draw, the
rebuilt weights of the drawn rows, the Gumbel argmax): the busy time of
the device events found between each draw span's two stream marks
(``lib/draw_trace.py``), not the host span's length, which in a step the
device paces holds waits and not the draw's work."""

from bench_port.lib import draw_trace


def read(ctx):
    d = draw_trace.get(ctx)
    return None if d is None else d["busy_us"] / 1e3 / d["steps"]
