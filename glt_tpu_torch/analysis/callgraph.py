"""Project call graph: who calls whom, cycle-tolerant, bounded-depth
(cf. ``glt_tpu/analysis/callgraph.py``).

Nodes are function ids (``module.Class.method`` / ``module.fn`` /
``module.outer.<locals>.inner``) assigned by :class:`~.symbols.Project`;
edges come from the call-resolution pass (one edge per resolvable call
site).  The graph is deliberately tolerant of the two things naive
bottom-up analyses choke on:

* **cycles** (mutual recursion, retry loops calling back into the
  protocol layer): Tarjan SCC condensation yields a callees-first order
  in which every strongly-connected component is processed as one unit —
  the effect engine iterates each SCC to a (bounded) fixpoint instead of
  recursing forever;
* **depth**: :meth:`CallGraph.reachable` takes a ``max_depth`` cutoff so
  queries (and transitive-effect chains built on them) stay bounded even
  on adversarial inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple


@dataclass(frozen=True)
class CallEdge:
    caller: str
    callee: str
    line: int


class CallGraph:
    def __init__(self, nodes: Iterable[str],
                 edges: Iterable[CallEdge]) -> None:
        self.nodes: List[str] = sorted(set(nodes))
        self.edges: List[CallEdge] = list(edges)
        self._out: Dict[str, List[CallEdge]] = {n: [] for n in self.nodes}
        for e in self.edges:
            self._out.setdefault(e.caller, []).append(e)
            if e.callee not in self._out:
                self._out[e.callee] = []
        if len(self._out) != len(self.nodes):
            self.nodes = sorted(self._out)

    def callees(self, fid: str) -> List[CallEdge]:
        return self._out.get(fid, [])

    # -- SCC condensation --------------------------------------------------
    def sccs(self) -> List[List[str]]:
        """Strongly connected components, callees-first (Tarjan order: a
        component is emitted only after everything it can reach).  The
        effect engine walks this order so callee summaries exist before
        their callers are summarized — and a recursive component is
        handled as one fixpoint unit, never an infinite descent."""
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        out: List[List[str]] = []
        counter = [0]

        for root in self.nodes:
            if root in index:
                continue
            # iterative Tarjan: (node, iterator position) work stack
            work: List[Tuple[str, int]] = [(root, 0)]
            while work:
                node, pi = work.pop()
                if pi == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                recurse = False
                succs = self._out.get(node, [])
                for i in range(pi, len(succs)):
                    succ = succs[i].callee
                    if succ not in index:
                        work.append((node, i + 1))
                        work.append((succ, 0))
                        recurse = True
                        break
                    if succ in on_stack:
                        low[node] = min(low[node], index[succ])
                if recurse:
                    continue
                if low[node] == index[node]:
                    comp: List[str] = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    out.append(sorted(comp))
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
        return out

    # -- bounded reachability ----------------------------------------------
    def reachable(self, fid: str,
                  max_depth: Optional[int] = None) -> Dict[str, int]:
        """BFS call-depths from ``fid`` (itself at depth 0); traversal
        stops at ``max_depth`` edges — the engine's bounded-depth cutoff."""
        depths: Dict[str, int] = {fid: 0}
        frontier = [fid]
        d = 0
        while frontier and (max_depth is None or d < max_depth):
            d += 1
            nxt: List[str] = []
            for cur in frontier:
                for e in self._out.get(cur, []):
                    if e.callee not in depths:
                        depths[e.callee] = d
                        nxt.append(e.callee)
            frontier = nxt
        return depths
