"""Platform selection and mesh device lists.

The counting path runs on a GPU.  A process runs on the CPU only when it
was put there on purpose (``--platform cpu`` or ``JAX_PLATFORMS=cpu``);
only then may a mesh use virtual CPU devices.  A GPU process whose mesh
asks for more cards than it has fails instead of quietly counting on the
host.
"""

from __future__ import annotations

import os

_COUNT_FLAG = "xla_force_host_platform_device_count"


def on_cpu_by_choice() -> bool:
    """True when JAX was pinned to the CPU (env var or config update)."""
    import jax

    return (jax.config.jax_platforms or "").strip().lower() == "cpu"


def select_platform(platform: str) -> None:
    """``cpu``: pin JAX to the host CPU.  ``gpu``: require device 0 to be a
    GPU, else raise with the platform JAX actually found."""
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return
    found = jax.devices()[0].platform
    if found != "gpu":
        raise RuntimeError(
            f"--platform gpu: JAX found no GPU (device 0 is {found!r}); "
            "run on a machine with a CUDA GPU, or pass --platform cpu"
        )


def request_virtual_cpu_devices(n: int) -> None:
    """Ask the CPU backend for ``n`` virtual devices.  XLA reads the flag
    when the CPU backend starts, so this only takes effect before the first
    computation touches it; an explicit count already in XLA_FLAGS wins."""
    flags = os.environ.get("XLA_FLAGS", "")
    if _COUNT_FLAG not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --{_COUNT_FLAG}={n}".strip()


def mesh_devices(n: int) -> list:
    """The first ``n`` devices of the default backend.  Raises when fewer
    exist; virtual CPU devices are requested only in a process that was put
    on the CPU on purpose."""
    import jax

    if on_cpu_by_choice():
        request_virtual_cpu_devices(n)
    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(
            f"a mesh of {n} devices needs {n} {devs[0].platform} devices; "
            f"this process has {len(devs)}"
        )
    return devs[:n]
