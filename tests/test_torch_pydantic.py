"""Pydantic models and the contextualizer: lancedb_tpu_torch
(device="cpu") against lancedb_tpu, mirroring tests/test_pydantic.py.

Each model converts to the same Arrow schema in both packages; a table
created from a model stores the same rows, and ``to_pydantic`` gives the
reference's instances. The contextualizer's windows are equal row for
row.
"""

from enum import Enum
from typing import Optional

import numpy as np
import pyarrow as pa
import pydantic
import pytest

import lancedb_tpu
import lancedb_tpu.context as ref_ctx
import lancedb_tpu.pydantic as ref_pyd
import lancedb_tpu_torch
import lancedb_tpu_torch.context as port_ctx
import lancedb_tpu_torch.pydantic as port_pyd

PKGS = ("port", "ref")
PYD = {"port": port_pyd, "ref": ref_pyd}
CTX = {"port": port_ctx, "ref": ref_ctx}


def _connect(pkg, path):
    if pkg == "port":
        return lancedb_tpu_torch.connect(str(path), device="cpu")
    return lancedb_tpu.connect(str(path))


def _item(pkg):
    p = PYD[pkg]

    class Item(p.LanceModel):
        id: int
        text: str
        price: float
        in_stock: bool = True
        note: Optional[str] = None
        vector: p.Vector(8)

    return Item


class StrStatus(str, Enum):
    PENDING = "pending"
    DONE = "done"


class IntPriority(int, Enum):
    LOW = 1
    HIGH = 3


def _schemas(build) -> tuple[pa.Schema, pa.Schema]:
    """build(pydantic module) → model, for each package, as Arrow schemas."""
    return tuple(PYD[p].pydantic_to_schema(build(PYD[p])) for p in PKGS)


def test_schema_conversion():
    port, ref = (_item(p).to_arrow_schema() for p in PKGS)
    assert port.equals(ref, check_metadata=True)
    assert port.field("id").type == pa.int64()
    assert port.field("text").type == pa.utf8()
    assert port.field("price").type == pa.float64()
    assert port.field("in_stock").type == pa.bool_()
    assert port.field("note").nullable
    assert port.field("vector").type == pa.list_(pa.float32(), 8)
    assert _item("port").field_names() == _item("ref").field_names()


def test_nested_model():
    def build(p):
        class Inner(p.LanceModel):
            a: int
            b: str

        class Outer(p.LanceModel):
            id: int
            meta: Inner

        return Outer

    port, ref = _schemas(build)
    assert port.equals(ref) and pa.types.is_struct(port.field("meta").type)


def test_list_and_dict():
    def build(p):
        class M(p.LanceModel):
            tags: list[str]
            attrs: dict[str, int]
            vector: p.Vector(4)

        return M

    port, ref = _schemas(build)
    assert port.equals(ref)
    assert port.field("tags").type == pa.list_(pa.utf8())
    assert port.field("attrs").type == pa.map_(pa.utf8(), pa.int64())


def test_multivector():
    def build(p):
        class M(p.LanceModel):
            id: int
            vecs: p.MultiVector(4)

        return M

    port, ref = _schemas(build)
    assert port.equals(ref)
    assert port.field("vecs").type == pa.list_(pa.list_(pa.float32(), 4))
    row = build(port_pyd)(id=1, vecs=np.ones((2, 4), np.float32))
    assert row.vecs == build(ref_pyd)(id=1, vecs=np.ones((2, 4), np.float32)).vecs


def test_vector_validation():
    for pkg in PKGS:
        with pytest.raises(pydantic.ValidationError):
            _item(pkg)(id=1, text="x", price=1.0, vector=[0.1, 0.2])  # wrong dim
    assert _item("port")(id=1, text="x", price=1.0, vector=np.arange(8)).vector == [
        float(i) for i in range(8)]


def test_unsupported_type_refused():
    for pkg in PKGS:
        class M(PYD[pkg].LanceModel):
            x: complex

        with pytest.raises(Exception, match="cannot convert") as e:
            PYD[pkg].pydantic_to_schema(M)
        assert type(e.value).__name__ == "InvalidInputError"


def test_create_from_model_and_to_pydantic(tmp_path):
    hits = {}
    for pkg in PKGS:
        item = _item(pkg)
        t = _connect(pkg, tmp_path / pkg).create_table("items", schema=item)
        t.add([item(id=1, text="apple pie", price=4.5, vector=[0.1] * 8),
               item(id=2, text="banana bread", price=3.0, vector=[0.9] * 8)])
        assert t.count_rows() == 2
        got = t.search(np.full(8, 0.1, np.float32)).limit(2).to_pydantic(item)
        assert isinstance(got[0], item) and got[0].id == 1
        assert t.query().where("id = 2").to_pydantic(item)[0].text == "banana bread"
        hits[pkg] = [m.model_dump() for m in got]
    assert hits["port"] == hits["ref"]


def test_model_dicts_roundtrip(tmp_path):
    rows = []
    for pkg in PKGS:
        t = _connect(pkg, tmp_path / pkg).create_table("items2", schema=_item(pkg))
        t.add([{"id": 3, "text": "x", "price": 1.0, "in_stock": False, "note": None,
                "vector": [0.0] * 8}])
        rows.append(t.to_arrow())
    assert rows[0].equals(rows[1])
    assert rows[0].to_pylist()[0]["in_stock"] is False


def test_enum_schema_and_roundtrip(tmp_path):
    class M(pydantic.BaseModel):
        status: StrStatus
        priority: IntPriority
        opt_status: Optional[StrStatus] = None

    port, ref = (PYD[p].pydantic_to_schema(M) for p in PKGS)
    assert port.equals(ref)
    assert port.field("status").type == pa.dictionary(pa.int32(), pa.utf8())
    assert port.field("priority").type == pa.int64()
    assert port.field("opt_status").nullable
    cols = []
    for pkg in PKGS:
        class Doc(PYD[pkg].LanceModel):
            id: int
            status: StrStatus
            vector: PYD[pkg].Vector(2)

        t = _connect(pkg, tmp_path / pkg).create_table("enum_rt", schema=Doc, mode="overwrite")
        t.add([Doc(id=1, status=StrStatus.PENDING, vector=[1.0, 0.0])])
        cols.append(t.to_arrow().column("status").to_pylist())
    assert cols[0] == cols[1] == ["pending"]


# ------------------------------------------------------------ contextualizer

DOCS = [
    {"doc": "a", "text": "one two three four five six"},
    {"doc": "b", "text": "alpha beta gamma"},
    {"doc": "a", "text": "seven eight"},
]


def _ctx(pkg, data=DOCS):
    return CTX[pkg].contextualize(data)


def test_window_stride():
    got, want = (_ctx(p).text_col("text").groupby("doc").window(4).stride(2).to_list()
                 for p in PKGS)
    assert got == want
    a_chunks = [r["text"] for r in got if r["doc"] == "a"]
    assert a_chunks[:2] == ["one two three four", "three four five six"]
    assert [r["text"] for r in got if r["doc"] == "b"] == ["alpha beta gamma"]


def test_min_window():
    got, want = (_ctx(p).text_col("text").groupby("doc").window(4).stride(4)
                 .min_window_size(3).to_list() for p in PKGS)
    assert got == want
    assert all(len(r["text"].split()) >= 3 for r in got)


@pytest.mark.parametrize("form", ["arrow", "pandas", "list"])
def test_contextualizer_outputs_and_inputs(form):
    data = {"arrow": pa.Table.from_pylist(DOCS), "list": DOCS}.get(form)
    if data is None:
        data = pa.Table.from_pylist(DOCS).to_pandas()
    got, want = (_ctx(p, data).text_col("text").window(3).stride(3).to_arrow() for p in PKGS)
    assert got.equals(want) and "text" in got.column_names
    for pkg in PKGS:
        with pytest.raises(Exception, match="text_col is required"):
            _ctx(pkg).window(3).to_list()
        with pytest.raises(Exception, match="window must be positive"):
            _ctx(pkg).window(0)
