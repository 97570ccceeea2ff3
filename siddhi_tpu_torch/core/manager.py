"""SiddhiManager — top-level factory (counterpart of
siddhi_tpu/core/manager.py).

`SiddhiManager(device=None)` runs on the CUDA card. Without a card it
raises; it never falls back to the CPU. Tests and CPU runs ask for the CPU
explicitly with `device="cpu"`."""

from __future__ import annotations

from typing import Optional, Union

import torch

from .. import compiler
from ..errors import SiddhiAppCreationError
from ..extension.registry import GLOBAL, ExtensionKind, Registry
from ..query_api import SiddhiApp
from .app_runtime import SiddhiAppRuntime

# built-in extension registration side effects
from ..ops import aggregators as _aggregators  # noqa: F401
from ..ops import builtin_functions as _builtin_functions  # noqa: F401
from ..ops import stream_functions as _stream_functions  # noqa: F401
from ..ops import window_factories as _window_factories  # noqa: F401
from ..io import record_table as _record_table  # noqa: F401


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "siddhi_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class SiddhiManager:
    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self.registry: Registry = GLOBAL.copy()
        self.runtimes: dict[str, SiddhiAppRuntime] = {}

    def create_siddhi_app_runtime(self, app: Union[str, SiddhiApp], *,
                                  batch_size: int = 0,
                                  group_capacity: int = 0,
                                  async_callbacks: bool = False,
                                  auto_flush_ms: Optional[float] = None,
                                  mesh=None, partition_capacity: int = 0
                                  ) -> Optional[SiddhiAppRuntime]:
        """Build a runtime. `async_callbacks=True` decodes stream callbacks
        on worker threads once the runtime starts; runtime.drain() is then
        the barrier. `auto_flush_ms` flushes staged rows on a wall clock
        once the runtime starts (also @app:autoFlush). `mesh`, a sequence
        of devices along one axis (one device: the runtime's own), runs an
        eligible partition on its key-slot path with `partition_capacity`
        slots (0: config.default_partition_capacity); without it every
        partition runs the per-key host loop."""
        if isinstance(app, str):
            app = compiler.parse(compiler.update_variables(app)
                                 if "${" in app else app)
        rt = SiddhiAppRuntime(app, self.registry, self.device,
                              batch_size=batch_size,
                              group_capacity=group_capacity,
                              async_callbacks=async_callbacks,
                              auto_flush_ms=auto_flush_ms, mesh=mesh,
                              partition_capacity=partition_capacity)
        self.runtimes[app.name] = rt
        return rt

    def get_siddhi_app_runtime(self, name: str) -> Optional[SiddhiAppRuntime]:
        return self.runtimes.get(name)

    def set_extension(self, name: str, impl,
                      kind: Optional[ExtensionKind] = None) -> None:
        """Register a per-manager extension as `namespace:name` (reference:
        SiddhiManager.setExtension). `kind` defaults by probing the impl's
        type."""
        if kind is None:
            from ..io.record_table import RecordStore
            from ..ops.aggregators import AggregatorFactory
            from ..ops.expr_compile import ScalarFunction
            from ..ops.window_factories import WindowFactory
            if isinstance(impl, AggregatorFactory):
                kind = ExtensionKind.AGGREGATOR
            elif isinstance(impl, ScalarFunction):
                kind = ExtensionKind.FUNCTION
            elif isinstance(impl, WindowFactory):
                kind = ExtensionKind.WINDOW
            elif (isinstance(impl, RecordStore)
                  or (isinstance(impl, type)
                      and issubclass(impl, RecordStore))):
                kind = ExtensionKind.STORE
            else:
                raise SiddhiAppCreationError(
                    f"cannot infer extension kind for {impl!r}; pass kind=")
        ns, _, nm = name.rpartition(":")
        self.registry.register(kind, ns, nm, impl)

    def shutdown(self) -> None:
        for rt in self.runtimes.values():
            rt.shutdown()
        self.runtimes.clear()
