"""node2vec node embeddings (Grover & Leskovec, KDD 2016): host-side numpy.

Counterpart of multistgraph_tpu/graph/node2vec.py, the same numpy
arithmetic and the same ``np.random.default_rng`` draws in the same order,
so that one seed gives walks and embeddings bit-identical to the JAX
package's. GMAN's paper learns its spatial embeddings with node2vec; the
zoo's GMAN takes any host-built (N, se_dim) table and defaults to
Laplacian eigenvectors, with this method behind ``gman_se='node2vec'``:
second-order biased random walks, then skip-gram with negative sampling.

Built for graph-build time at N <= a few thousand (dense adjacency): all
``num_walks * N`` walkers advance together, each step one (W, N)
transition-probability block and one vectorized inverse-CDF draw, and the
skip-gram trains in vectorized minibatches with scatter-add updates.
"""

from typing import Tuple

import numpy as np


def _row_sample(probs: np.ndarray, rng) -> np.ndarray:
    """One categorical draw per row of a (W, N) probability matrix."""
    cdf = np.cumsum(probs, axis=1)
    cdf /= cdf[:, -1:]
    u = rng.random((len(probs), 1))
    return (u > cdf).sum(axis=1).astype(np.int64)


def node2vec_walks(adj: np.ndarray, num_walks: int = 10, walk_length: int = 80,
                   p: float = 1.0, q: float = 1.0, seed: int = 0) -> np.ndarray:
    """(num_walks*N, walk_length) int array of second-order biased walks.

    Transition weight from cur to x given prev:
      w(cur,x) * [1/p if x == prev; 1 if x in N(prev); 1/q otherwise].
    Isolated nodes self-loop.
    """
    rng = np.random.default_rng(seed)
    a = np.asarray(adj, np.float64)
    a = np.maximum(a, a.T)
    n = len(a)
    np.fill_diagonal(a, 0.0)
    dead = a.sum(axis=1) == 0
    if dead.any():  # self-loop so walkers on isolated nodes stay put
        a[dead, dead] = 1.0
    nbr = a > 0

    starts = np.tile(np.arange(n), num_walks)
    walks = np.empty((len(starts), walk_length), np.int64)
    walks[:, 0] = starts
    # first hop: plain weighted transition
    cur = _row_sample(a[starts], rng)
    if walk_length > 1:
        walks[:, 1] = cur
    prev = starts
    for t in range(2, walk_length):
        trans = a[cur].copy()  # (W, N)
        bias = np.where(nbr[prev], 1.0, 1.0 / q)
        bias[np.arange(len(cur)), prev] = 1.0 / p
        trans *= bias
        nxt = _row_sample(trans, rng)
        walks[:, t] = nxt
        prev, cur = cur, nxt
    return walks


def _skipgram_pairs(walks: np.ndarray, window: int, rng) -> Tuple[np.ndarray, np.ndarray]:
    """(center, context) index arrays from walks, word2vec-style shrunken
    windows (offset for each pair drawn uniformly from 1..window)."""
    w, length = walks.shape
    centers, contexts = [], []
    for off in range(1, window + 1):
        keep = rng.random((w, length - off)) < (1.0 / off)  # 1/off shrinkage
        c = walks[:, :-off][keep]
        x = walks[:, off:][keep]
        centers.append(np.concatenate([c, x]))  # symmetric pairs
        contexts.append(np.concatenate([x, c]))
    return np.concatenate(centers), np.concatenate(contexts)


def node2vec_embedding(adj: np.ndarray, dim: int, num_walks: int = 10,
                       walk_length: int = 80, window: int = 10,
                       p: float = 1.0, q: float = 1.0, negatives: int = 5,
                       epochs: int = 2, lr: float = 0.025,
                       batch: int = 256, seed: int = 0) -> np.ndarray:
    """(N, dim) float32 node embeddings via skip-gram + negative sampling."""
    rng = np.random.default_rng(seed)
    n = len(adj)
    walks = node2vec_walks(adj, num_walks, walk_length, p, q, seed)
    centers, contexts = _skipgram_pairs(walks, window, rng)

    # unigram^(3/4) negative-sampling table over walk visit counts
    counts = np.bincount(walks.reshape(-1), minlength=n).astype(np.float64)
    neg_p = counts ** 0.75
    neg_p /= neg_p.sum()

    u = (rng.random((n, dim)) - 0.5) / dim  # input (the returned embedding)
    v = np.zeros((n, dim))                  # output/context
    order = rng.permutation(len(centers))
    centers, contexts = centers[order], contexts[order]
    steps = max(1, (len(centers) + batch - 1) // batch)
    total = epochs * steps
    done = 0
    for _ in range(epochs):
        for b0 in range(0, len(centers), batch):
            eta = lr * max(1e-4, 1.0 - done / total)
            done += 1
            c = centers[b0: b0 + batch]
            x = contexts[b0: b0 + batch]
            neg = rng.choice(n, size=(len(c), negatives), p=neg_p)
            uc = u[c]                              # (B, d)
            vx = v[x]                              # (B, d)
            vn = v[neg]                            # (B, K, d)
            # positive: maximize log sigmoid(u·v); logits clipped so a batch
            # of stale same-node updates can't overflow/saturate
            spos = np.clip((uc * vx).sum(-1), -6.0, 6.0)
            gpos = 1.0 / (1.0 + np.exp(spos))      # 1 - sigmoid
            du = gpos[:, None] * vx
            np.add.at(v, x, eta * gpos[:, None] * uc)
            # negatives: minimize log sigmoid(u·v_neg)
            sneg = 1.0 / (1.0 + np.exp(
                -np.clip((uc[:, None, :] * vn).sum(-1), -6.0, 6.0)))  # (B, K)
            du -= np.einsum("bk,bkd->bd", sneg, vn)
            np.add.at(v, neg, -eta * sneg[..., None] * uc[:, None, :])
            np.add.at(u, c, eta * du)
    norm = np.linalg.norm(u, axis=1, keepdims=True)
    return (u / np.maximum(norm, 1e-8)).astype(np.float32)
