"""siddhi_tpu_torch — the PyTorch/CUDA port of siddhi_tpu.

The same user surface as the JAX package — SiddhiQL text through
`SiddhiManager().create_siddhi_app_runtime(text)`, `InputHandler.send` /
`send_batch` / `send_columns`, stream and query callbacks — running on an
NVIDIA card (sm_90a) with hand-written CUDA kernels under `csrc/`:

    from siddhi_tpu_torch import SiddhiManager

    rt = SiddhiManager().create_siddhi_app_runtime('''
        define stream StockStream (symbol string, price float, volume long);
        from StockStream[price > 20.0]#window.lengthBatch(1000)
        select symbol, avg(price) as avgPrice group by symbol
        insert into OutputStream;
    ''')
    rt.add_callback("OutputStream", print)
    rt.get_input_handler("StockStream").send(("IBM", 75.6, 100))
    rt.flush()

`add_callback(stream, fn, columnar=True)` delivers `ColumnarBlock`s
(compacted numpy columns) instead of Event lists; with
`create_siddhi_app_runtime(..., async_callbacks=True)` callbacks are
decoded on worker threads once `start()` runs, and `drain()` is the
barrier. Every callback reads a step's output back in one packed copy
(kernel K12a on the card).

`SiddhiManager()` runs on the card and raises without one;
`SiddhiManager(device="cpu")` runs the plain PyTorch versions of the
kernels on the CPU. The package never imports JAX or siddhi_tpu.
"""

from . import compiler  # noqa: F401
from .core.dtypes import config  # noqa: F401
from .core.event import Event  # noqa: F401
from .core.manager import SiddhiManager  # noqa: F401
from .core.stream import StreamCallback  # noqa: F401
from .errors import SiddhiError, SiddhiParserError  # noqa: F401
from .query_api import SiddhiApp  # noqa: F401
