"""The port's copies of the framework-free serving modules -- page pool
and prefix cache, scheduler policy, n-gram proposer -- give the same
results as the originals under one scripted op sequence."""

import numpy as np
import pytest

from paddle_tpu.serve import paged as j_paged
from paddle_tpu.serve import policy as j_policy
from paddle_tpu.serve import speculative as j_spec
from paddle_tpu_torch.serve import paged as t_paged
from paddle_tpu_torch.serve import policy as t_policy
from paddle_tpu_torch.serve import speculative as t_spec


def _script(mod):
    """Drive one PagePool through admissions with shared prefixes,
    decode extends, speculative reserve/commit, exhaustion and
    releases; return every observable result in order."""
    pool = mod.PagePool(num_pages=12, page_size=4, slots=3,
                        max_pages_per_slot=6, prefix_cache_blocks=4)
    rs = np.random.RandomState(0)
    pre = rs.randint(0, 50, 8)
    prompts = [np.concatenate([pre, rs.randint(0, 50, n)]) for n in (3, 5)]
    prompts.append(rs.randint(0, 50, 9))
    log = []
    for slot, p in enumerate(prompts):
        log.append(("admit", pool.admit(slot, p, len(p))))
        pool.register(slot, p, len(p))
        log.append(("counters", pool.counters()))
    for _ in range(5):
        for slot in range(3):
            try:
                log.append(("extend", pool.extend(slot)))
            except mod.PoolExhaustedError as e:
                log.append(("exhausted", str(e)))
    pool.release(2)
    log.append(("reserve", pool.reserve(0, 3)))
    log.append(("commit", pool.commit(0, 1)))
    log.append(("headroom", pool.headroom(), pool.evictable()))
    probe = np.concatenate([pre, rs.randint(0, 50, 4)])
    log.append(("probe", pool.pages_needed(probe, len(probe)),
                pool.admissible(probe, len(probe))))
    log.append(("chain", mod.chain_keys(probe, len(probe), 4)))
    log.append(("blocks", mod.blocks_for(13, 4),
                mod.shareable_blocks(13, 4)))
    pool.release(0)
    pool.release(1)
    pool.reconcile()
    log.append(("final", pool.counters(), pool.slot_pages))
    return log


def test_page_pool_copy_matches_original():
    assert _script(t_paged) == _script(j_paged)


def test_policy_copy_matches_original():
    class Rep:
        def __init__(self, n):
            self.n = n

        def load(self):
            return self.n

    reps = [Rep(3), Rep(1), Rep(2)]
    chain = [("a",), ("b",)]
    for mod_a, mod_b in [(t_policy, j_policy)]:
        a, b = mod_a.SchedulerPolicy(), mod_b.SchedulerPolicy()
        assert a.next_index([4, 5]) == b.next_index([4, 5])
        assert (a.preemption_victim([(0, 3), (1, 9), (2, 5)])
                == b.preemption_victim([(0, 3), (1, 9), (2, 5)]) == 1)
        assert a.prefill_slots([3, 1, 2]) == b.prefill_slots([3, 1, 2])
        assert a.should_decode(0, 2) == b.should_decode(0, 2)
        for pos in (0, 10, 30):
            assert (a.draft_len(pos=pos, max_len=32, remaining=3)
                    == b.draft_len(pos=pos, max_len=32, remaining=3))
        assert a.route(chain, {("b",): reps[2]}, reps) is reps[2]
        assert b.route(chain, {("b",): reps[2]}, reps) is reps[2]
        assert a.route(chain, {}, reps) is b.route(chain, {}, reps)
        assert (a.route_tiered(chain, {}, reps[:1], reps[1:])
                is b.route_tiered(chain, {}, reps[:1], reps[1:]))
        assert (mod_a.RandomRoutingPolicy(3).route(chain, {}, reps)
                is mod_b.RandomRoutingPolicy(3).route(chain, {}, reps))


@pytest.mark.parametrize("history", [
    [1, 2, 3, 1, 2, 3, 1, 2],
    [5, 6, 7, 8],
    [9, 9, 9, 9, 9],
    [1, 2, 1, 3, 1, 2],
])
def test_ngram_proposer_copy_matches_original(history):
    for k in (1, 3, 6):
        assert (t_spec.NGramProposer().draft(history, k)
                == j_spec.NGramProposer().draft(history, k))
        assert (t_spec.NGramProposer(2, 1).propose(history, k)
                == j_spec.NGramProposer(2, 1).propose(history, k))
