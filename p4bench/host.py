"""Where a run's process runs on its host: the readings of the run's
``p4bench:`` line that say which CPUs it ran on, how near they lie to the
card, how fast they clocked and how busy the host was.  Linux only; a
reading the host does not give is None.
"""
from __future__ import annotations

import os
import resource
from pathlib import Path

PCI = Path("/sys/bus/pci/devices")


def cpu_now():
    """The CPU this process last ran on (field 39 of /proc/self/stat)."""
    try:
        with open("/proc/self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, ValueError, IndexError):
        return None


def cpulist(text: str) -> list:
    """The CPUs of a kernel CPU list such as ``0-3,8,10-11``."""
    cpus = []
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus += range(int(lo), int(hi or lo) + 1)
    return cpus


def _read(path):
    try:
        return Path(path).read_text().strip()
    except OSError:
        return None


def bus_id_of(props) -> str | None:
    """The PCI address of a card from torch's device properties."""
    try:
        return (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
                f"{props.pci_device_id:02x}.0")
    except AttributeError:
        return None


def card_cpus(bus_id):
    """(NUMA node, CPUs local to the card) of the card at ``bus_id``."""
    if bus_id is None:
        return None, None
    node = _read(PCI / bus_id / "numa_node")
    local = _read(PCI / bus_id / "local_cpulist")
    return (None if node is None else int(node),
            None if local is None else cpulist(local))


def mhz(cpus) -> dict:
    """Each of ``cpus``'s clock in MHz from /proc/cpuinfo."""
    out, cpu = {}, None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key == "processor":
                    cpu = int(val)
                elif key == "cpu MHz" and (cpus is None or cpu in cpus):
                    out[cpu] = float(val)
    except (OSError, ValueError):
        pass
    return out


def loadavg():
    text = _read("/proc/loadavg")
    return None if text is None else text.split()[:3]


def usage() -> dict:
    """This process's CPU seconds (user, system), page faults and context
    switches so far."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return dict(user_s=r.ru_utime, system_s=r.ru_stime, faults=r.ru_minflt,
                voluntary=r.ru_nvcsw, involuntary=r.ru_nivcsw)


def steal():
    """The host's stolen CPU time so far, in clock ticks, all CPUs
    together (/proc/stat): time a CPU of this machine waited for the
    machine under it."""
    text = _read("/proc/stat")
    try:
        return int(text.splitlines()[0].split()[8])
    except (AttributeError, IndexError, ValueError):
        return None


def affinity() -> list:
    return sorted(os.sched_getaffinity(0))
