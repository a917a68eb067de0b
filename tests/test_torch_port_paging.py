"""paddle_tpu_torch.inference.paging against paddle_tpu.inference.paging.

The port keeps its own copy of the page allocator and the prefix trie.
Every scenario here runs the same operation sequence on both packages
and records what each call returns and what the pool and trie look like
after it; the two traces must be equal, and the port's must show the
behaviour paddle_tpu's own tests pin (tests/test_paged_engine.py:45-140):
all-or-nothing alloc, refcounted sharing, first-writer-wins insert, LRU
leaf eviction that never frees a page a slot still holds, and crc32
fingerprints equal to the prompt's ``chain_hashes``.
"""
import numpy as np
import pytest

import paddle_tpu.inference.paging as jpg
import paddle_tpu_torch.inference.paging as tpg


def _both(run):
    """(paddle_tpu trace, port trace) of ``run(module)``."""
    return run(jpg), run(tpg)


def _state(a, t=None):
    out = [list(a._free), sorted(a._refs.items())]
    if t is not None:
        out += [t.pages_cached, t.reclaimable(), sorted(t.fingerprints())]
    return out


def test_allocator_alloc_free_refcount():
    def run(pg):
        a = pg.PageAllocator(4)
        got = a.alloc(3)
        out = [sorted(got), a.free_pages, a.alloc(2), a.free_pages]
        a.incref([got[0]])
        out += [a.decref([got[0]]), a.decref(got), a.free_pages]
        a.check()
        with pytest.raises(AssertionError):
            a.decref([0])
        with pytest.raises(AssertionError):
            a.incref([1])
        return out + _state(a)
    j, t = _both(run)
    assert t == j
    assert t[:7] == [[0, 1, 2], 1, None, 1, 0, 3, 4]


def test_trie_match_insert_evict():
    def run(pg):
        a = pg.PageAllocator(8)
        t = pg.PrefixTrie(a)
        k1, k2 = tuple(range(4)), tuple(range(4, 8))
        p = a.alloc(2)
        out = [t.insert([k1, k2], p), t.match([k1, k2]),
               t.match([k1, (9, 9, 9, 9)]), t.match([(7, 7, 7, 7)])]
        a.decref(p)
        out.append(a.used_pages)
        a.incref([p[0]])                 # a slot pins the head page
        out += [t.evict(2), a.refcount(p[0]), a.free_pages]
        a.decref([p[0]])
        out += [t.evict(1), a.free_pages]
        a.check()
        return out + _state(a, t)
    j, t = _both(run)
    assert t == j
    assert t[:10] == [2, [0, 1], [0], [], 2, 1, 2, 7, 1, 8]


def test_trie_first_writer_wins_and_lru_order():
    def run(pg):
        a = pg.PageAllocator(8)
        t = pg.PrefixTrie(a)
        key = (1, 2)
        pg1 = a.alloc(1)
        out = [t.insert([key], pg1)]
        pg2 = a.alloc(1)
        out += [t.insert([key], pg2), t.match([key]), t.pages_cached]
        a.decref(pg1)
        a.decref(pg2)
        out.append(a.free_pages)
        other = a.alloc(1)
        t.insert([(3, 4)], other)
        a.decref(other)
        t.match([key])                   # refresh pg1: other is now LRU
        out += [t.evict(1), a.refcount(pg1[0]), a.refcount(other[0])]
        return out + _state(a, t)
    j, t = _both(run)
    assert t == j
    assert t[:8] == [1, 0, [0], 1, 7, 1, 1, 0]


def test_pages_needed_and_chain_hashes():
    for tokens, ps in ((1, 16), (16, 16), (17, 16), (1024, 16), (0, 8)):
        assert tpg.pages_needed(tokens, ps) == jpg.pages_needed(tokens, ps)
    assert [tpg.pages_needed(n, 16) for n in (1, 16, 17)] == [1, 1, 2]
    rs = np.random.RandomState(0)
    for n, ps in ((0, 4), (7, 4), (8, 4), (300, 16), (5, 0)):
        toks = rs.randint(0, 50304, n)
        assert tpg.chain_hashes(toks, ps) == jpg.chain_hashes(toks, ps)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    assert tpg.chain_hashes(prompt[:7], 4) == tpg.chain_hashes(prompt, 4)[:1]
    other = tpg.chain_hashes([1, 2, 3, 4, 9, 9, 9, 9], 4)
    mine = tpg.chain_hashes(prompt, 4)
    assert other[0] == mine[0] and other[1] != mine[1]


def test_trie_fingerprints_match_prompt_chain_hashes():
    def run(pg):
        a = pg.PageAllocator(8)
        t = pg.PrefixTrie(a)
        prompt = [1, 2, 3, 4, 5, 6, 7, 8]
        t.insert([tuple(prompt[0:4]), tuple(prompt[4:8])], a.alloc(2))
        fps = t.fingerprints()
        return [sorted(fps), set(pg.chain_hashes(prompt, 4)) <= set(fps),
                len(t.fingerprints(limit=1))]
    j, t = _both(run)
    assert t == j
    assert len(t[0]) == 2 and t[1] is True and t[2] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_churn_traces_match(seed):
    """500 random allocator and trie operations (alloc, decref, insert of
    a fresh page chain, match with an incref of the matched pages, evict,
    evict_all) on both packages: every return value and the state after
    every operation agree, the allocator's invariants hold throughout,
    and once every holder lets go the trie drains the pool."""
    def run(pg):
        rs = np.random.RandomState(seed)
        a = pg.PageAllocator(24)
        t = pg.PrefixTrie(a)
        held, trace = [], []
        keys = [tuple(rs.randint(0, 3, 2)) for _ in range(6)]
        for _ in range(500):
            op = rs.randint(6)
            if op == 0:
                got = a.alloc(int(rs.randint(1, 5)))
                trace.append(("alloc", got))
                if got is not None:
                    held.append(got)
            elif op == 1 and held:
                trace.append(("decref",
                              a.decref(held.pop(rs.randint(len(held))))))
            elif op == 2:
                # an admission's fresh pages, registered as its prefix
                chain = [keys[i] for i in rs.randint(0, 6, rs.randint(1, 4))]
                pages = a.alloc(len(chain))
                trace.append(("insert", pages and t.insert(chain, pages)))
                if pages is not None:
                    held.append(pages)
            elif op == 3:
                chain = [keys[i] for i in rs.randint(0, 6, rs.randint(1, 4))]
                m = t.match(chain)
                a.incref(m)              # an admission pins its match
                held.append(m)
                trace.append(("match", m))
            elif op == 4:
                trace.append(("evict", t.evict(int(rs.randint(1, 4)))))
            elif op == 5 and rs.rand() < 0.1:
                trace.append(("evict_all", t.evict_all()))
            a.check()
            trace.append(_state(a, t))
        for pages in held:
            a.decref(pages)
        t.evict_all()
        a.check()
        trace.append((a.free_pages, t.pages_cached))
        return trace
    j, t = _both(run)
    assert t == j
    assert t[-1] == (24, 0)
