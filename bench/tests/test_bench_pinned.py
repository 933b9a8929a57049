"""The seven accepted cells send, key and recompute exactly what they did
before a configuration could carry ``spec`` and ``reference``: their
rounds, warm-up included, each request's stream key, and the keywords the
reference's ``run_rows`` is called with."""
import hashlib
import itertools
import json

import numpy as np
import pytest

from bench import check, harness, traffic

#: Two seeds, one past 32 signed bits as the driver's are.
SEEDS = (2**31 + 3838, 7)
#: Stats a stand-in ``run_rows`` returns, the fields ``records`` reduces.
STATS = ("utilization", "w2", "wa", "gvt", "max_dev", "min_dev")

#: Of each cell at its full size and each seed, recorded before the two
#: keys came in: the sha256 of (the first three warm rounds, the first
#: three rounds), of every request's stream key at each of its points, of
#: the keywords of each ``run_rows`` call that the comparison of a run
#: makes (the rounds of ``check.sample`` over two rounds, the points of
#: ``check.drawn``), and the count of those calls.
PINNED = {
    "exact_mix.ring10k": {
        SEEDS[0]: (
            "0f9d8eeb2c55bc082a0b71b147ac417f19685d6f96a3ed9ddc0ec31a62553ef7",
            "2f71c19e226e6cceb32a03d97cb17da38fd3c274b1f20d9e44140f6dbbaf0221",
            "b122a7fd50b60597e66d5069559156ce7d9983c600c849d5faeefa0c94ce3f93",
            1),
        SEEDS[1]: (
            "414013d9d3e37d5dfba008131061f658d38b304900bd382f5be84ef9ac8a5b71",
            "4c8abb741c699adaa08164f557807eb9fd6df7de53bbf6929e7e68b93aad0be0",
            "dfe126e34f5f0925792c6667e211dcabc17f650de5bbf5493386eb69929814b7",
            1),
    },
    "exact_mix.ring1m": {
        SEEDS[0]: (
            "3478e171be075562c38709e5d2c716d7f6fadcaec0b0019cd13c762116d6741b",
            "8f0f27bd04c03850e78e3b812d49cf2d5964f9345f41f04dc47f84c266d3d9e7",
            "fcfd21b186b49c681e5bef1c994fc1279cda10514729e08ab44a6489c37b8163",
            1),
        SEEDS[1]: (
            "bd93a205a3fad3a93df10149f30dafdf2c0b5b3728384004d584473c4816d832",
            "0d6e9c17451c3b6c75089a21b48bbb8adc54249da14cbec23102253f9fd26a85",
            "afba32701129b42397b4ad506cf2c11aeabd181dc36af7c473eccfb9f3412b90",
            1),
    },
    "exact_mix.ring512k": {
        SEEDS[0]: (
            "cfeea91c53f6fe63022e9ae78a86c020043a9576b3e2bc5fd5732aa07f51201f",
            "2e9927303914013e8623d620fe4da54baf200766d5a133885bc63636c511e871",
            "6ec2d40079f338d6187efa4379f89ae7e87342ac9137a952788241ff7910e24e",
            1),
        SEEDS[1]: (
            "ed8233757b258c478ce5351d4c1abfd5b8cb472abe2994ee9564c03753445912",
            "4f25eb081f159a726e1fe634650e49ef723d24c012f7e82e63af37349e3d13b1",
            "4e4646190efd86244b9c072e36164c07be27e8c165cc17a2bf857779eefece1b",
            1),
    },
    "growth_mix.ring1m": {
        SEEDS[0]: (
            "d9c87096eb359f04812a6cc07fe9afa3f070fcd732b2ae84105e8dce06b5152f",
            "07ccd910d2b17cf5468ebe3ed18c7b9d801cf760c8ec4b67689638a3be7ce98e",
            "b9ed9ef43b88f8e95de2f0667f4dca3f3a3463bf88c20082f016272fcbc69574",
            1),
        SEEDS[1]: (
            "b8b7c80a711d003ec89768e2df6e98a16080885689d22ab63430f1bcd03bc7da",
            "43bd40bdd8ea2f17b27ecc97505f4f22e8a2e95dc8ef71fd4d58718ea9684e8f",
            "a7d00c78dd38308deb84372ee43e862959449e62807f8baacfa542020d9adbfe",
            1),
    },
    "exact_mix.ring8m": {
        SEEDS[0]: (
            "5dfaaaa18e5b0554eaabb32a3b9850f3da87c25e6d243aafa4755681aa17cce7",
            "933bedfe4a53f6c8fe11c675e0d0f49de53367f6054dacc10feab91b1d1294c4",
            "91d6e9cf569b8db5c35af7d3c64c238cec3ed6d7c2440c2be756a2741d0ef92e",
            1),
        SEEDS[1]: (
            "35ecd369aaa5a2fdc30945c68db0c5b67cd9b7f6d98d6ed8cbd3491427d0f667",
            "e29ece048a892ece0158febc3866fd4e7b2e21e0efd7c5308682076d7b2ad9cb",
            "ae01b3fa37610917e8c5292adc64c4bf590577046a568e8cdd6b58e0c1733b4d",
            1),
    },
    "stale_fused_mix.ring1m": {
        SEEDS[0]: (
            "e1a02b524368e55deb89417445ae2387bb05a2918b6704f7f0dee86ead24b718",
            "fa1ca734320a47d87cddcdf64a039f383761a981bd7dc15463045c9959455e31",
            "b4ea2edd3968dcf54030c9fe0eed147f322ae90ba3a33851a0f570b9323f6e3e",
            1),
        SEEDS[1]: (
            "89c0fe35fe508bb7a90bc29ab2e4d3627e80135a6315cc218fdb7aa6be8e468a",
            "29524fa7a74b97e50b064f73c2646408d4afbbd0fe6626ab4d88ae39801bdd1f",
            "930643e1145de0bb81c513257e6ad9bd598cfeb2dd801decb3f70da52ec07c3b",
            1),
    },
    "exact_mix.size_grid": {
        SEEDS[0]: (
            "c5e1f4a0dc17b1428f40ec791d2a8416a2ae3ac71763ceabe7b7ce2e8e11d0b5",
            "1b031769ae3ebef806557a72c3652e0c2829a1ee0e7ce91afb974ada31cb9b90",
            "c82906b35d8f3e16dc089db60733c25f65cf17918f4eaac76fcc036192b8a9b9",
            7),
        SEEDS[1]: (
            "d8454ec4a1bd060794922d63588d312e0e6d8ec5b2a7daf0f05d2bb181678d83",
            "4a9d63f393c801189142826e30df4c87d68f8a9558be633915adeb93243cdfdf",
            "561d861ca42b30eeac0e00e7dcf264c269ba07d6ac947ea9c1ed76bce60c6008",
            7),
    },
}


def _digest(x) -> str:
    return hashlib.sha256(json.dumps(x, sort_keys=True, default=str)
                          .encode()).hexdigest()


def _pins(root, name: str, seed: int, monkeypatch) -> tuple:
    cell = harness.load_cell(root, name)
    conf, mix, sizes = cell["config"], cell["mix"], cell["cell"]
    rnds = [list(itertools.islice(traffic.rounds(conf, mix, sizes, seed,
                                                 warm=w), 3))
            for w in (True, False)]
    keys = [[check._stream_key(q, L, n_v) for L, n_v, _ in check.points(q)]
            for r in rnds for rnd in r for q in rnd]
    calls = []

    def run_rows(**kw):
        calls.append(kw)
        return {f: np.ones((kw["n_steps"], len(kw["trials"])), np.float32)
                for f in STATS}

    ref = cell["reference"]
    monkeypatch.setattr(ref, "run_rows", run_rows)
    log = [[{"request": q} for q in rnd] for rnd in rnds[1][:2]]
    reqs = [e["request"] for e in check.sample(log, seed)]
    check.reference_records(reqs, "cpu", keep=check.drawn(conf, seed),
                            reference=ref)
    return _digest(rnds), _digest(keys), _digest(calls), len(calls)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", PINNED)
def test_rounds_stream_keys_and_reference_calls_as_before(
        full_root, name, seed, monkeypatch):
    assert _pins(full_root, name, seed, monkeypatch) == PINNED[name][seed]
