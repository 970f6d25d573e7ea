"""A transaction stream as plain integer arrays.

The generators emit this; the plain reference reads it as it is, and the
harness wraps it into the program's ``Txn`` objects.  Opcodes and the key
encoding are frozen here, apart from the program: the values of the
switch opcodes (P4DB §5.4) and ``node * 10**9 + local`` keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

NOP, READ, WRITE, ADD, CADD, ADDP = 0, 1, 2, 3, 4, 5
WRITES = (WRITE, ADD, CADD, ADDP)
NODE_STRIDE = 1_000_000_000


def key_of(node, local):
    return node * NODE_STRIDE + local


def node_of(key):
    return key // NODE_STRIDE


@dataclass
class Stream:
    """``n`` transactions: txn i is kind ``kinds[kind[i]]``, issued at node
    ``home[i]``, with ops ``op/key/val[start[i]:start[i + 1]]`` in order."""
    kinds: List[str]
    kind: np.ndarray
    home: np.ndarray
    start: np.ndarray
    op: np.ndarray
    key: np.ndarray
    val: np.ndarray

    @property
    def n(self) -> int:
        return len(self.home)

    def prefix(self, n: int) -> "Stream":
        """The first ``n`` transactions."""
        m = int(self.start[n])
        return Stream(self.kinds, self.kind[:n], self.home[:n],
                      self.start[:n + 1], self.op[:m], self.key[:m],
                      self.val[:m])
