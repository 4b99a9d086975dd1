"""GPU accelerator manager, the counterpart of the JAX package's TPU
manager (reference: python/ray/_private/accelerators/nvidia_gpu.py —
CUDA_VISIBLE_DEVICES, then the devfs device files).

Detection is passive: it reads the ``FAKE_CHIPS`` knob, the environment
and ``/dev``, and never initializes CUDA, because ``detect_resources``
runs in the driver's own process and a CUDA context there would hold
memory on every card. A container may see the device files of cards it
was not given (``/dev/nvidia0`` beside its own ``/dev/nvidia1``, the
first refused by the device cgroup), so a card counts only if this
process may open its file; opening it creates no CUDA context."""

from __future__ import annotations

import glob
import os
import re

from ray_tpu_torch._private.accelerators.accelerator import AcceleratorManager

# /dev/nvidia0, /dev/nvidia1, ...: one file per card (nvidiactl,
# nvidia-uvm and nvidia-caps are not cards).
_CARD_FILE = re.compile(r"/dev/nvidia[0-9]+$")


def _usable(path: str) -> bool:
    """Whether this process may open the card's device file."""
    try:
        os.close(os.open(path, os.O_RDWR))
    except OSError:
        return False
    return True


class GPUAcceleratorManager(AcceleratorManager):
    def resource_name(self) -> str:
        return "GPU"

    def detect_ids(self) -> list[str]:
        """The node's card ids, as a lease's ``CUDA_VISIBLE_DEVICES``
        names them: the entries of this process's
        ``CUDA_VISIBLE_DEVICES`` where it is set (as the strings listed
        there, up to the first entry CUDA would stop at); else the
        ``/dev/nvidiaN`` files this process may open, in minor order,
        numbered from 0 as CUDA numbers the cards it can open under
        ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` (the driver gives minors in PCI
        order; a container given /dev/nvidia3 alone sees it as device 0);
        under ``FAKE_CHIPS=n``, ``0..n-1``."""
        from ray_tpu_torch._private import config

        fake = config.get("FAKE_CHIPS")
        if fake != "":  # "0" is a valid fake (simulate a GPU-less host)
            return [str(i) for i in range(int(fake))]
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            # "" means explicitly zero visible cards; CUDA stops at the
            # first invalid entry ("-1", "NoDevFiles").
            ids = []
            for dev in visible.split(","):
                dev = dev.strip()
                if not dev or dev.startswith("-") or dev == "NoDevFiles":
                    break
                ids.append(dev)
            return ids
        try:
            paths = [p for p in glob.glob("/dev/nvidia*")
                     if _CARD_FILE.match(p) and _usable(p)]
        except OSError:
            return []
        return [str(i) for i in range(len(paths))]

    def detect_count(self) -> int:
        return len(self.detect_ids())

    def detect_labels(self) -> dict[str, str]:
        # What the host exposes without a CUDA context: the driver's
        # proc entry names the card model.
        labels: dict[str, str] = {}
        for path in sorted(glob.glob("/proc/driver/nvidia/gpus/*/information")):
            try:
                with open(path) as f:
                    for line in f:
                        key, _, val = line.partition(":")
                        if key.strip() == "Model" and val.strip():
                            labels["ray_tpu_torch.io/accelerator-type"] = (
                                val.strip()
                            )
                            return labels
            except OSError:
                continue
        return labels
