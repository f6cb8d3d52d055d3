"""Small shared algorithms, standard library only
(``howtotrainyourmamlpytorch_tpu/utils/algo.py``): the strongly connected
components that ``utils/locksan.py`` reads cycles from."""

from __future__ import annotations


def tarjan_scc(adj: dict[str, set]) -> list[list[str]]:
    """Strongly-connected components of ``{node: successors}`` with two
    or more members, each sorted — i.e. the node sets participating in
    some cycle. Iterative (no recursion limit on deep graphs);
    deterministic order via sorted traversal. Self-loops are NOT
    reported: both call sites exclude same-node edges at construction,
    so a single-node component is by definition cycle-free here."""
    for node in list(adj):
        for succ in adj[node]:
            adj.setdefault(succ, set())
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    out: list[list[str]] = []

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                component = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    component.append(w)
                    if w == node:
                        break
                if len(component) >= 2:
                    out.append(sorted(component))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    return out
