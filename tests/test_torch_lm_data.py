"""The port's token stream (``repro_torch.data.tokens``) against the JAX
package's (``repro.data.tokens``): ``batch_at`` bit for bit across seeds,
steps, shards and the unstructured stream, and the Prefetcher's order equal
to the direct stream."""
import numpy as np
import pytest

from repro.data.tokens import Prefetcher as JPrefetcher
from repro.data.tokens import TokenStream as JStream

from repro_torch.data.tokens import Prefetcher, TokenStream

CASES = [  # (vocab, batch, seq, seed, shard, num_shards, structured)
    (256, 4, 16, 0, 0, 1, True),
    (256, 4, 16, 7, 0, 1, True),
    (128256, 8, 33, 0, 0, 1, True),       # llama's vocab, a seq not a multiple of 8
    (50, 6, 9, 3, 1, 3, True),            # the second of three shards
    (50, 6, 9, 3, 2, 3, False),
    (256, 2, 1, 11, 0, 1, False),
]


@pytest.mark.parametrize("vocab,batch,seq,seed,shard,num_shards,structured", CASES)
def test_batch_at_bit_for_bit(vocab, batch, seq, seed, shard, num_shards, structured):
    want = JStream(vocab, batch, seq, seed, shard, num_shards, structured)
    got = TokenStream(vocab, batch, seq, seed, shard, num_shards, structured)
    for step in (0, 1, 5, 1000):
        a, b = want.batch_at(step), got.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape
            assert b[k].shape == (batch // num_shards, seq)
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{k} step {step}")
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        assert b["tokens"].min() >= 0 and b["tokens"].max() < vocab


def test_steps_and_shards_differ():
    s = TokenStream(256, 4, 16, seed=0)
    assert not np.array_equal(s.batch_at(0)["tokens"], s.batch_at(1)["tokens"])
    a = TokenStream(256, 4, 16, seed=0, shard=0, num_shards=2).batch_at(0)["tokens"]
    b = TokenStream(256, 4, 16, seed=0, shard=1, num_shards=2).batch_at(0)["tokens"]
    assert a.shape == (2, 16) and not np.array_equal(a, b)


def test_shards_must_divide_the_batch():
    with pytest.raises(ValueError, match="not divisible"):
        TokenStream(256, 5, 16, num_shards=2)


def test_prefetcher_matches_direct_stream():
    stream = TokenStream(100, 4, 16, seed=3)
    ref = JPrefetcher(JStream(100, 4, 16, seed=3), start_step=2, depth=2)
    pf = Prefetcher(stream, start_step=2, depth=2)
    try:
        for want_step in range(2, 6):
            step, batch = next(pf)
            rstep, rbatch = next(ref)
            assert step == rstep == want_step
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(batch[k], stream.batch_at(step)[k])
                np.testing.assert_array_equal(batch[k], rbatch[k])
    finally:
        pf.close()
        ref.close()
    assert not pf._thread.is_alive()
