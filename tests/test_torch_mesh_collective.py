"""The port's row exchange across ``gloo`` ranks on the CPU
(``kernels/collective.py`` with a mesh), mirroring
``tests/test_collective.py:167-215, 540-659``: ``apply_row_sources``,
``swap_expert_rows``, ``broadcast_expert_row``, ``apply_layer_permutation(
via="collective")`` and ``MigrationExecutable(mesh=…)`` give the host
gather's rows bit for bit, at (1, 4) and (2, 2) (each data row runs the
same exchange on its replica of the pool), and their ``CollectiveStats``
equal JAX's, from JAX's mesh path run in a subprocess on the same maps.
Every rank's swapped router tables are equal, and the executable ships
exactly the moved rows that change rank."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import ranks, run_jax  # noqa: E402
from repro_torch.kernels import collective as tcoll  # noqa: E402
from repro_torch.models.moe import apply_layer_permutation  # noqa: E402
from repro_torch.online.migration import lower_row_sources  # noqa: E402
from repro_torch.sharding import ShardingPolicy  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(1, 4), (2, 2)]
S = 8  # slots: 2 a rank at model 4, 4 at model 2
L = 3


def _arrays(seed=0, D=4, F=6):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((S, D, F), (S, D, F), (S, F, D)))


def _maps(seed=1):
    """Row-source maps: random (any map), a permutation, a swap set, a
    broadcast."""
    rng = np.random.default_rng(seed)
    maps = [rng.integers(0, S, size=S).astype(np.int32) for _ in range(2)]
    maps.append(rng.permutation(S).astype(np.int32))
    return maps


ARRAYS = _arrays()
MAPS = _maps()
SWAPS = [(0, 5), (2, 3), (1, 6)]
BROADCAST = (1, [4, 6, 0])
STACK = [np.random.default_rng(7 + i).normal(size=(L, S, 4, 6)).astype(np.float32)
         for i in range(3)]
EXEC_MAPS = [np.random.default_rng(11 + t).integers(0, S, size=(L, S)).astype(np.int32)
             for t in range(2)]
PERM_MAP = np.stack([np.random.default_rng(20 + layer).permutation(S)
                     for layer in range(L)]).astype(np.int32)
PERM_MAP[1] = np.arange(S)  # an identity layer issues nothing
TABLES = np.stack([np.random.default_rng(30 + layer).permutation(S)
                   for layer in range(L)]).astype(np.int32)
GATHER_MAP = np.random.default_rng(40).integers(0, S, size=(L, 12)).astype(np.int32)


def _stats(st):
    return (st.rows_rewritten, st.cross_rows, st.local_rows, st.rounds,
            st.payload_bytes)


def _rank(mesh):
    m, me = mesh.size("model"), mesh.index("model")
    per = S // m
    mine = slice(me * per, (me + 1) * per)
    blocks = tuple(torch.from_numpy(a[mine].copy()) for a in ARRAYS)
    before = [b.clone() for b in blocks]
    out = {"apply": [], "swap": None, "bcast": None}
    for src in MAPS:
        new, st = tcoll.apply_row_sources(blocks, src, mesh=mesh)
        out["apply"].append(([t.numpy() for t in new], _stats(st)))
    assert all(torch.equal(a, b) for a, b in zip(blocks, before))  # inputs kept
    new, st = tcoll.swap_expert_rows(blocks, SWAPS, mesh=mesh)
    out["swap"] = ([t.numpy() for t in new], _stats(st))
    new, st = tcoll.broadcast_expert_row(blocks, *BROADCAST, mesh=mesh)
    out["bcast"] = ([t.numpy() for t in new], _stats(st))
    # apply_layer_permutation on a stacked pool under the policy
    policy = ShardingPolicy(mesh=mesh)
    moe = {n: torch.from_numpy(np.stack([a] * 2)[:, mine].copy())
           for n, a in zip(("w_gate", "w_up", "w_down"), ARRAYS)}
    stats_out = []
    permuted = apply_layer_permutation(moe, 1, MAPS[2], via="collective",
                                       policy=policy, stats_out=stats_out)
    host = apply_layer_permutation(moe, 1, MAPS[2], via="host", policy=policy)
    out["layer_perm"] = ({n: permuted[n].numpy() for n in moe},
                         [_stats(s) for s in stats_out],
                         {n: host[n].numpy() for n in moe})
    # the serving executable, in place, with the table swap
    ex = tcoll.MigrationExecutable(mesh=mesh, axis="model")
    execs = []
    for src in EXEC_MAPS + [PERM_MAP]:
        ws = [torch.from_numpy(w[:, mine].copy()) for w in STACK]
        ptrs = [w.data_ptr() for w in ws]
        tables = torch.from_numpy(TABLES) if src is PERM_MAP else None
        sent = ex.sent_rows
        (wg, wu, wd), new_tables = ex(src, tables, *ws)
        assert [w.data_ptr() for w in (wg, wu, wd)] == ptrs  # in place
        execs.append(([w.numpy() for w in (wg, wu, wd)],
                      None if new_tables is None else new_tables.numpy(),
                      ex.sent_rows - sent))
    out["exec"] = (execs, ex.received_rows)
    # gather_rows: an 8-slot pool into a 12-slot one (the replicated
    # pool's install), sharded and whole
    s_out = 12
    ins = [torch.from_numpy(w[:, mine].copy()) for w in STACK]
    outs = [w.new_empty((L, s_out // m, *w.shape[2:])) for w in ins]
    tcoll.gather_rows(mesh, "model", GATHER_MAP, ins, outs)
    whole = [w.new_empty((L, s_out, *w.shape[2:])) for w in ins]
    tcoll.gather_rows(mesh, "model", GATHER_MAP, ins, whole)
    out["gather"] = ([w.numpy() for w in outs], [w.numpy() for w in whole])
    return out


def jax_stats(payload):
    """JAX's ``CollectiveStats`` and rows for the same maps on its mesh
    path (4 forced host devices)."""
    import jax.numpy as jnp

    from repro.kernels import collective as jcoll
    from repro.launch.mesh import make_host_mesh

    out = {}
    arrays = tuple(jnp.asarray(a) for a in payload["arrays"])
    for data, model in payload["shapes"]:
        mesh = make_host_mesh(data, model)

        def stats(st):
            return (st.rows_rewritten, st.cross_rows, st.local_rows,
                    st.rounds, st.payload_bytes)

        res = {"apply": []}
        for src in payload["maps"]:
            new, st = jcoll.apply_row_sources(arrays, src, mesh=mesh)
            res["apply"].append(([np.asarray(t) for t in new], stats(st)))
        new, st = jcoll.swap_expert_rows(arrays, payload["swaps"], mesh=mesh)
        res["swap"] = ([np.asarray(t) for t in new], stats(st))
        new, st = jcoll.broadcast_expert_row(arrays, *payload["bcast"],
                                             mesh=mesh)
        res["bcast"] = ([np.asarray(t) for t in new], stats(st))
        out[(data, model)] = res
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_collective")
    port = {shape: ranks(_rank, *shape, tmp) for shape in SHAPES}
    jax_out = run_jax("test_torch_mesh_collective:jax_stats", {
        "shapes": SHAPES, "arrays": ARRAYS, "maps": MAPS, "swaps": SWAPS,
        "bcast": BROADCAST}, tmp)
    return port, jax_out


def _whole(per_rank, shape, key_fn, axis=0):
    """The global pool (slot dim ``axis``) from the ranks of data row 0
    (each data row holds the same replica, checked too)."""
    data, model = shape
    rows = [key_fn(per_rank[r]) for r in range(data * model)]
    for d in range(1, data):
        for q in range(model):
            for a, b in zip(rows[q], rows[d * model + q]):
                np.testing.assert_array_equal(a, b)
    return [np.concatenate([rows[q][i] for q in range(model)], axis=axis)
            for i in range(len(rows[0]))]


@pytest.mark.parametrize("case", range(len(MAPS)))
@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_apply_row_sources_matches_host_gather_and_jax(results, shape, case):
    port, jax_out = results
    src = MAPS[case]
    got = _whole(port[shape], shape, lambda o: o["apply"][case][0])
    for g, a in zip(got, ARRAYS):
        assert np.array_equal(g, a[src])
    want_rows, want_stats = jax_out[shape]["apply"][case]
    for g, w in zip(got, want_rows):
        assert np.array_equal(g, w)
    sch = lower_row_sources(src, shape[1])
    for o in port[shape]:
        assert o["apply"][case][1] == want_stats
        assert o["apply"][case][1][1] == sch.cross_rows


@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_swap_and_broadcast_named_entry_points(results, shape):
    port, jax_out = results
    src = np.arange(S)
    for a, b in SWAPS:
        src[[a, b]] = src[[b, a]]
    bsrc = np.arange(S)
    bsrc[BROADCAST[1]] = BROADCAST[0]
    for key, want_src in (("swap", src), ("bcast", bsrc)):
        got = _whole(port[shape], shape, lambda o: o[key][0])
        for g, a in zip(got, ARRAYS):
            assert np.array_equal(g, a[want_src])
        for o in port[shape]:
            assert o[key][1] == jax_out[shape][key][1]


@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_apply_layer_permutation_collective_reports_its_traffic(results, shape):
    port, jax_out = results
    got = _whole(port[shape], shape,
                 lambda o: [o["layer_perm"][0][n] for n in
                            ("w_gate", "w_up", "w_down")], axis=1)
    host = _whole(port[shape], shape,
                  lambda o: [o["layer_perm"][2][n] for n in
                             ("w_gate", "w_up", "w_down")], axis=1)
    for g, h, a in zip(got, host, ARRAYS):
        assert np.array_equal(g, h)
        assert np.array_equal(g[1], a[MAPS[2]]) and np.array_equal(g[0], a)
    for o in port[shape]:
        assert o["layer_perm"][1] == [jax_out[shape]["apply"][2][1]]


@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_migration_executable_matches_host_gather_in_place(results, shape):
    """Any map (broadcasts and permutations), whole stacks: the ranks'
    blocks put together are the host executable's rows; the swapped
    tables are equal on every rank and to the host inverse."""
    port, _ = results
    data, model = shape
    host = tcoll.MigrationExecutable()
    for t, src in enumerate(EXEC_MAPS + [PERM_MAP]):
        ws = [torch.from_numpy(w.copy()) for w in STACK]
        tables = torch.from_numpy(TABLES) if src is PERM_MAP else None
        (hg, hu, hd), htab = host(src, tables, *ws)
        per = S // model
        for d in range(data):
            blocks = [port[shape][d * model + q]["exec"][0][t][0]
                      for q in range(model)]
            for i, want in enumerate((hg, hu, hd)):
                got = np.concatenate([blocks[q][i] for q in range(model)],
                                     axis=1)
                assert np.array_equal(got, want.numpy())
        cross = sum(int(((src[layer] != np.arange(S))
                         & (src[layer] // per != np.arange(S) // per)).sum())
                    for layer in range(L))
        sent = [port[shape][r]["exec"][0][t][2] for r in range(data * model)]
        assert sum(sent) == data * cross  # each data row ships its own
        for r in range(data * model):
            got_tab = port[shape][r]["exec"][0][t][1]
            if tables is None:
                assert got_tab is None
            else:
                assert np.array_equal(got_tab, htab.numpy())
    total_recv = sum(port[shape][r]["exec"][1] for r in range(data * model))
    total_sent = sum(sum(e[2] for e in port[shape][r]["exec"][0])
                     for r in range(data * model))
    assert total_recv == total_sent > 0


@pytest.mark.parametrize("shape", SHAPES, ids=["1x4", "2x2"])
def test_gather_rows_into_a_larger_pool(results, shape):
    """The replicated pool's install: each slot of a 12-slot pool takes
    its row of the 8-slot pool from the rank that holds it, into a sharded
    pool and into a whole one on every rank."""
    port, _ = results
    data, model = shape
    for i, w in enumerate(STACK):
        want = np.take_along_axis(w, GATHER_MAP[:, :, None, None], axis=1)
        for d in range(data):
            sharded = np.concatenate(
                [port[shape][d * model + q]["gather"][0][i]
                 for q in range(model)], axis=1)
            assert np.array_equal(sharded, want)
        for r in range(data * model):
            assert np.array_equal(port[shape][r]["gather"][1][i], want)
