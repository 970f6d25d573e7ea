"""Logical transactions as the workloads emit them and the DBMS runs them.

A Txn is an ordered list of logical operations over global tuple keys.
Operation kinds mirror the switch opcodes (core.packets) so hot txns
translate 1:1 into switch packets; ADDP operands reference earlier op
indices (read-dependent writes)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.packets import ADD, ADDP, CADD, NOP, READ, WRITE

_ids = itertools.count()


@dataclass
class Txn:
    kind: str                                  # workload txn type
    ops: List[Tuple[int, int, int]]            # (opcode, key, operand)
    home: int = 0                              # issuing node
    tid: int = field(default_factory=lambda: next(_ids))
    _ops_np: Optional[np.ndarray] = field(default=None, repr=False,
                                          compare=False)

    @property
    def ops_np(self) -> np.ndarray:
        """The op list as an [n_ops, 3] int64 array, parsed once and
        cached — the batched packet builder flattens whole admission
        groups by concatenating these instead of iterating Python tuples.
        ``ops`` is FROZEN after construction: the DBMS never mutates it
        and derived sub-txns build new Txn objects; in-place mutation
        would serve a stale cache."""
        if self._ops_np is None:
            self._ops_np = np.array(self.ops, np.int64).reshape(-1, 3)
        return self._ops_np

    def keys(self):
        return [k for _, k, _ in self.ops]

    def write_keys(self):
        return [k for o, k, _ in self.ops if o in (WRITE, ADD, CADD, ADDP)]

    def read_only(self):
        return all(o == READ for o, _, _ in self.ops)


def key_of(node: int, local: int) -> int:
    return node * 1_000_000_000 + local


def node_of(key: int) -> int:
    return key // 1_000_000_000
