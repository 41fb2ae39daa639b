"""The namespace catalogues of lancedb_tpu_torch (device="cpu") against
lancedb_tpu's: the directory catalogue (namespace.py), the REST catalogue
and its server (namespace_rest.py), and the connection's namespace
methods.

Each case of tests/test_namespace.py runs once in each package, on
catalogues of its own, and what each step returns or raises is compared:
listings, descriptions (their creation times aside), row counts, search
results (ids exactly, distances to rtol 1.3e-5 with an atol of 1e-5 |q|²)
and error types and messages. The cross-package cases hold a namespace
tree written by either package to the other's listing and search, and a
REST catalogue of either package serving a table the other one wrote.
Every server runs under a ``with`` block.
"""

import numpy as np
import pyarrow as pa
import pytest

import lancedb_tpu
import lancedb_tpu.namespace
import lancedb_tpu.namespace_rest
import lancedb_tpu_torch
from conftest import make_vector_table

PKGS = {"port": lancedb_tpu_torch, "ref": lancedb_tpu}
DEV = {"port": {"device": "cpu"}, "ref": {}}
Q = np.random.default_rng(3).standard_normal(16).astype(np.float32)


def _ns(side, path):
    return PKGS[side].connect_namespace(str(path), **DEV[side])


def _same_hits(got: pa.Table, want: pa.Table) -> None:
    assert got.column_names == want.column_names
    np.testing.assert_array_equal(np.asarray(got["id"]), np.asarray(want["id"]))
    np.testing.assert_allclose(np.asarray(got["_distance"]), np.asarray(want["_distance"]),
                               rtol=1.3e-5, atol=1e-5 * float((Q.astype(np.float64) ** 2).sum()))


def _outcome(fn):
    """What a step returns, or the type name and message of what it raises."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 - compared between the packages
        return ("raised", type(exc).__name__, str(exc))


def _describe(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "created_at"}


# ------------------------------------------- the directory catalogue

NS_CASES = {
    "create_list_describe": lambda ns: [
        ns.create_namespace(["prod"]),
        ns.create_namespace(["prod", "search"], properties={"owner": "team-a"}),
        ns.create_namespace(["dev"]),
        ns.list_namespaces(), ns.list_namespaces(["prod"]),
        _describe(ns.describe_namespace(["prod", "search"])),
        ns.namespace_exists(["prod"]), ns.namespace_exists(["missing"]),
    ],
    "parent_must_exist": lambda ns: [_outcome(lambda: ns.create_namespace(["a", "b"]))],
    "duplicate": lambda ns: [
        ns.create_namespace(["x"]), _outcome(lambda: ns.create_namespace(["x"])),
        ns.create_namespace(["x"], mode="exist_ok"), ns.list_namespaces(),
    ],
    "drop": lambda ns: [ns.create_namespace(["tmp"]), ns.drop_namespace(["tmp"]),
                        ns.namespace_exists(["tmp"])],
    "drop_non_empty_requires_force": lambda ns: [
        ns.create_namespace(["n"]),
        ns.create_table(["n", "t"], make_vector_table(5)).count_rows(),
        _outcome(lambda: ns.drop_namespace(["n"])),
        ns.drop_namespace(["n"], force=True), ns.namespace_exists(["n"]),
    ],
    "table_lifecycle": lambda ns: [
        ns.create_namespace(["prod"]),
        ns.create_table(["prod", "items"], make_vector_table(40)).count_rows(),
        ns.list_tables(["prod"]), ns.table_exists(["prod", "items"]),
        ns.open_table(["prod", "items"]).count_rows(),
        ns.open_table(["prod", "items"]).namespace, ns.open_table(["prod", "items"]).id,
        ns.drop_table(["prod", "items"]), ns.list_tables(["prod"]),
    ],
    "root_tables": lambda ns: [ns.create_table(["top"], make_vector_table(5)).id,
                               ns.list_tables(), ns.open_table(["top"]).namespace],
    "missing_namespace": lambda ns: [
        _outcome(lambda: ns.create_table(["ghost", "t"], make_vector_table(2))),
        _outcome(lambda: ns.create_namespace(["bad/seg"])),
        _outcome(lambda: ns.drop_namespace([])),
    ],
    "same_name_table_and_namespace": lambda ns: [
        ns.create_namespace(["dual"]), ns.create_table(["dual-table"], make_vector_table(2)).id,
        ns.list_namespaces(), ns.list_tables(),
    ],
}


@pytest.mark.parametrize("case", sorted(NS_CASES))
def test_directory_catalogue(tmp_path, case):
    got, want = (NS_CASES[case](_ns(side, tmp_path / side)) for side in ("port", "ref"))
    assert got == want


def test_namespace_table_search(tmp_path):
    """A table opened through the catalogue searches on its device: the
    same hits as the reference's."""
    hits = []
    for side in ("port", "ref"):
        ns = _ns(side, tmp_path / side)
        ns.create_namespace(["prod"])
        ns.create_table(["prod", "items"], make_vector_table(300))
        t = ns.open_table(["prod", "items"])
        hits.append(t.search(Q).limit(5).to_arrow())
    _same_hits(*hits)
    t = _ns("port", tmp_path / "port").open_table(["prod", "items"])
    assert t._device.type == "cpu" and t.uri.endswith("/prod/items.lance")


def test_connection_namespace_methods(tmp_path):
    """LanceDBConnection's namespace methods go to the catalogue over its
    root, on its device."""
    out = []
    for side in ("port", "ref"):
        db = PKGS[side].connect(str(tmp_path / side), **DEV[side])
        db.create_table("flat", make_vector_table(4))
        db.create_namespace(["a"], properties={"k": "v"})
        db.create_namespace(["a", "b"])
        out.append([db.list_namespaces(), db.list_namespaces(["a"]), db.namespace_exists(["a"]),
                    _describe(db.describe_namespace(["a"])), db.table_names(),
                    _outcome(lambda: db.drop_namespace(["a"])),
                    db.drop_namespace(["a"], force=True), db.list_namespaces()])
        if side == "port":
            assert db.namespace_client.device == db.device
    assert out[0] == out[1]


# ------------------------------------------------- the REST catalogue


@pytest.fixture()
def served(tmp_path):
    """A REST catalogue of each package with an API key, and a client of
    each package on its own package's server."""
    port_srv = lancedb_tpu_torch.NamespaceServer(str(tmp_path / "port"), api_key="sekrit",
                                                 device="cpu")
    ref_srv = lancedb_tpu.NamespaceServer(str(tmp_path / "ref"), api_key="sekrit")
    with port_srv, ref_srv:
        yield {
            "port": (lancedb_tpu_torch.connect_namespace_client(port_srv.address,
                                                                api_key="sekrit", device="cpu"),
                     port_srv),
            "ref": (lancedb_tpu.connect_namespace_client(ref_srv.address, api_key="sekrit"),
                    ref_srv),
        }


def _rest_crud(ns):
    ns.create_namespace(["prod"])
    ns.create_namespace(["prod", "search"], properties={"team": "ml"})
    out = [ns.namespace_exists(["prod", "search"]), ns.list_namespaces(["prod"]),
           ns.describe_namespace(["prod", "search"])["properties"]]
    ns.drop_namespace(["prod", "search"])
    return out + [ns.namespace_exists(["prod", "search"]), ns.namespace_exists([])]


def _rest_tables(ns):
    ns.create_namespace(["prod"])
    t = ns.create_table(["prod", "items"], [{"id": i, "vector": [float(i)] * 4} for i in range(32)])
    out = [t.count_rows(), ns.table_exists(["prod", "items"]), ns.list_tables(["prod"])]
    t.add([{"id": 100, "vector": [99.0] * 4}])  # the data plane: straight at storage
    t2 = ns.open_table(["prod", "items"])
    out += [t2.count_rows(), t2.search([99.0] * 4).limit(1).to_list()[0]["id"]]
    ns.rename_table(["prod", "items"], ["prod", "items2"])
    out.append(ns.list_tables(["prod"]))
    ns.drop_table(["prod", "items2"])
    return out + [ns.table_exists(["prod", "items2"])]


@pytest.mark.parametrize("case", ["crud", "tables"])
def test_rest_catalogue(served, case):
    fn = _rest_crud if case == "crud" else _rest_tables
    got, want = (fn(served[side][0]) for side in ("port", "ref"))
    assert got == want


def test_rest_auth_required(served):
    msgs = []
    for side, pkg in PKGS.items():
        client = pkg.remote.client
        bad = pkg.connect_namespace_client(
            served[side][1].address, api_key="wrong",
            config=client.ClientConfig(retry_config=client.RetryConfig(retries=0)))
        with pytest.raises(pkg.errors.HttpError) as e:
            bad.list_namespaces()
        msgs.append((e.value.status_code, str(e.value)))
    assert msgs[0] == msgs[1] and msgs[0][0] == 401


def test_min_timestamp_pierces_a_stale_cache(tmp_path):
    """A describe served from the TTL cache misses a write until the
    writer's baseline (bumped by Table._on_write) raises the freshness
    floor, in each package."""
    out = []
    for side, pkg in PKGS.items():
        with pkg.NamespaceServer(str(tmp_path / side), describe_cache_ttl=3600.0,
                                 **DEV[side]) as srv:
            writer = pkg.connect_namespace_client(srv.address, **DEV[side])
            reader = pkg.connect_namespace_client(srv.address, **DEV[side])
            writer.create_table(["t1"], [{"id": 1, "vector": [0.0] * 4}])
            v1 = reader.describe_table(["t1"])["version"]
            writer.open_table(["t1"]).add([{"id": 2, "vector": [1.0] * 4}])
            strict = pkg.connect_namespace_client(srv.address, read_consistency_interval=0.0,
                                                  **DEV[side])
            out.append([v1, reader.describe_table(["t1"])["version"],
                        writer.describe_table(["t1"])["version"],
                        strict.describe_table(["t1"])["version"]])
    assert out[0] == out[1] and out[0][1] == out[0][0] < out[0][2] == out[0][3]


def test_compute_min_timestamp_rule():
    from lancedb_tpu_torch.namespace_rest import compute_min_timestamp as port_rule

    ref_rule = lancedb_tpu.namespace_rest.compute_min_timestamp
    for args in ((None, None, 100.0), (90.0, None, 100.0), (None, 30.0, 100.0),
                 (90.0, 30.0, 100.0), (50.0, 30.0, 100.0), (None, 200.0, 100.0)):
        assert port_rule(*args) == ref_rule(*args)
    assert port_rule(50.0, 30.0, 100.0) == 70.0


# ------------------------------------------------------ across packages


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_tree_written_by_either_package(tmp_path, writer):
    """A namespace tree one package wrote is listed, described, opened and
    searched alike by both."""
    ns = _ns(writer, tmp_path)
    ns.create_namespace(["prod"], properties={"owner": writer})
    ns.create_namespace(["prod", "search"])
    ns.create_table(["prod", "search", "items"], make_vector_table(200, seed=4))
    ns.create_table(["top"], make_vector_table(3))
    views, hits = [], []
    for side in ("port", "ref"):
        reader = _ns(side, tmp_path)
        views.append([reader.list_namespaces(), reader.list_namespaces(["prod"]),
                      _describe(reader.describe_namespace(["prod"])), reader.list_tables(),
                      reader.list_tables(["prod", "search"]),
                      reader.table_exists(["prod", "search", "items"])])
        hits.append(reader.open_table(["prod", "search", "items"]).search(Q).limit(5).to_arrow())
    assert views[0] == views[1]
    _same_hits(*hits)


@pytest.mark.parametrize("server", ["port", "ref"])
def test_a_rest_catalogue_serves_the_other_packages_table(tmp_path, server):
    """A REST catalogue of one package serves a table the other package
    wrote; both packages' clients open it through the catalogue (the port's
    on the CPU) and get the same hits."""
    other = "ref" if server == "port" else "port"
    _ns(other, tmp_path).create_namespace(["prod"])
    _ns(other, tmp_path).create_table(["prod", "items"], make_vector_table(200, seed=5))
    hits = []
    with PKGS[server].NamespaceServer(str(tmp_path), **DEV[server]) as srv:
        for side in ("port", "ref"):
            client = PKGS[side].connect_namespace_client(srv.address, **DEV[side])
            assert client.list_tables(["prod"]) == ["items"]
            t = client.open_table(["prod", "items"])
            hits.append(t.search(Q).limit(5).to_arrow())
            if side == "port":
                assert t._device.type == "cpu"
    _same_hits(*hits)
