import numpy as np
import pytest

from alfi_tpu.mesh import (
    alfeld,
    box_mesh,
    mesh_hierarchy,
    rectangle_mesh,
    refine_uniform,
    unit_cube_mesh,
    unit_square_mesh,
)


def test_rectangle_counts():
    m = rectangle_mesh(4, 3, 2.0, 1.5)
    assert m.num_vertices == 5 * 4
    assert m.num_cells == 4 * 3 * 2
    # Euler: V - E + F(cells) = 1 for a disk
    assert m.num_vertices - m.num_edges + m.num_cells == 1
    assert np.isclose(m.cell_volumes().sum(), 2.0 * 1.5)


@pytest.mark.parametrize("diagonal", ["left", "right", "crossed"])
def test_rectangle_diagonals(diagonal):
    m = rectangle_mesh(3, 3, 2.0, 2.0, diagonal=diagonal)
    assert np.isclose(m.cell_volumes().sum(), 4.0)
    assert np.all(m.cell_volumes() > 0)
    # boundary tags: 4 sides all marked
    for tag in [1, 2, 3, 4]:
        assert len(m.boundary_facets(tag)) > 0
    mids = m.vertices[m.facet_vertices[m.boundary_facets(1)]].mean(axis=1)
    assert np.allclose(mids[:, 0], 0.0)
    mids = m.vertices[m.facet_vertices[m.boundary_facets(4)]].mean(axis=1)
    assert np.allclose(mids[:, 1], 2.0)


def test_box_counts():
    m = box_mesh(2, 3, 4, 1.0, 1.0, 2.0)
    assert m.num_cells == 2 * 3 * 4 * 6
    assert np.isclose(m.cell_volumes().sum(), 2.0)
    assert np.all(m.cell_volumes() > 0)
    for tag in range(1, 7):
        assert len(m.boundary_facets(tag)) > 0
    mids = m.vertices[m.facet_vertices[m.boundary_facets(6)]].mean(axis=1)
    assert np.allclose(mids[:, 2], 2.0)


def test_refine_2d():
    m = rectangle_mesh(2, 2, 1.0, 1.0)
    f = refine_uniform(m)
    assert f.num_cells == 4 * m.num_cells
    assert np.isclose(f.cell_volumes().sum(), 1.0)
    # markers survive: each boundary side doubles its facet count
    for tag in [1, 2, 3, 4]:
        assert len(f.boundary_facets(tag)) == 2 * len(m.boundary_facets(tag))
    # birth levels: facets on coarse skeleton have birth 0
    coarse_skel = f.facet_birth_level == 0
    new = f.facet_birth_level == 1
    assert coarse_skel.sum() == 2 * m.num_facets
    assert new.sum() == f.num_facets - 2 * m.num_facets


def test_refine_3d():
    m = unit_cube_mesh(2)
    f = refine_uniform(m)
    assert f.num_cells == 8 * m.num_cells
    assert np.isclose(f.cell_volumes().sum(), 1.0)
    assert np.all(f.cell_volumes() > 0)
    for tag in range(1, 7):
        assert len(f.boundary_facets(tag)) == 4 * len(m.boundary_facets(tag))
    assert (f.facet_birth_level == 0).sum() == 4 * m.num_facets


@pytest.mark.parametrize("dim", [2, 3])
def test_alfeld(dim):
    m = unit_square_mesh(2) if dim == 2 else unit_cube_mesh(2)
    b = alfeld(m)
    assert b.num_cells == (dim + 1) * m.num_cells
    assert b.num_vertices == m.num_vertices + m.num_cells
    assert np.isclose(b.cell_volumes().sum(), 1.0)
    assert np.all(b.cell_volumes() > 0)
    # macro vertices = original vertices only
    assert b.macro_vertices.sum() == m.num_vertices
    # old facets survive with markers
    for tag in [1, 2]:
        assert len(b.boundary_facets(tag)) == len(m.boundary_facets(tag))
    # child ordering contract: child k of cell c at c*(d+1)+k contains face k
    c = 0
    centroid = m.cell_coords()[c].mean(axis=0)
    for k in range(dim + 1):
        child = b.cells[c * (dim + 1) + k]
        verts = set(child.tolist())
        face = set(m.cells[c][[j for j in range(dim + 1) if j != k]].tolist())
        assert face <= verts
        assert np.allclose(b.vertices[child].max(axis=0) >= centroid, True)


@pytest.mark.parametrize("kind", ["uniform", "bary", "uniformbary"])
def test_hierarchy(kind, dim=2):
    base = unit_square_mesh(2)
    mh = mesh_hierarchy(base, kind, 2)
    assert len(mh) == 3
    for l in range(2):
        c2f = mh.coarse_to_fine_cells(l)
        assert c2f.shape[0] == mh[l].num_cells
        # fine cells covering coarse cells tile the fine mesh (each fine
        # cell appears d+1 times for the non-nested bary maps, once else)
        rep = dim + 1 if kind == "bary" else 1
        assert np.array_equal(
            np.sort(c2f.ravel()),
            np.repeat(np.arange(mh[l + 1].num_cells), rep),
        )
        # volumes of mapped fine cells sum to overlapping coarse volume
        vols_f = mh[l + 1].cell_volumes()
        vols_c = mh[l].cell_volumes()
        covered = vols_f[c2f].sum(axis=1)
        if kind == "bary":
            # non-nested: the c2f block covers the whole uniform macro cell
            assert np.allclose(covered, (dim + 1) * vols_c)
        else:
            assert np.allclose(covered, vols_c)


def test_bary_hierarchy_birth_levels():
    base = unit_square_mesh(2)
    mh = mesh_hierarchy(base, "bary", 2)
    fine = mh[2]
    # alfeld-interior facets never count as coarse at their own level
    centroid_facets = fine.facet_birth_level == 2
    assert centroid_facets.sum() > 0
    assert (fine.facet_birth_level <= 1).sum() > 0


def _write_msh22(path, mesh, tag=1):
    """Write ``mesh`` as ASCII Gmsh MSH 2.2: cells plus every exterior
    facet under physical tag ``tag``."""
    ctype, ftype = (4, 2) if mesh.dim == 3 else (2, 1)
    verts = np.zeros((mesh.num_vertices, 3))
    verts[:, :mesh.dim] = mesh.vertices
    facets = mesh.facet_vertices[mesh.exterior_facets]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(len(verts))]
    lines += ["%d %.17g %.17g %.17g" % (i + 1, *v)
              for i, v in enumerate(verts)]
    lines += ["$EndNodes", "$Elements", str(len(facets) + mesh.num_cells)]
    eid = 0
    for etype, conn in ((ftype, facets), (ctype, mesh.cells)):
        for c in conn:
            eid += 1
            lines.append("%d %d 2 %d %d %s" % (
                eid, etype, tag, tag, " ".join(str(v + 1) for v in c)))
    lines.append("$EndElements")
    path.write_text("\n".join(lines) + "\n")


def test_gmsh_read(tmp_path):
    import os

    from alfi_tpu.mesh import gmsh_read

    m = gmsh_read(os.path.join(os.path.dirname(__file__), "fixtures",
                               "bfs2d_coarse12.msh"))
    assert m.dim == 2
    assert m.num_cells > 1000
    assert np.all(m.cell_volumes() > 0)
    # physical tags 1 (inflow), 2 (noslip), 3 (outflow)
    for tag in [1, 2, 3]:
        assert len(m.boundary_facets(tag)) > 0
    # all exterior facets are marked
    assert np.all(m.facet_markers[m.exterior_facets] > 0)
    cube = unit_cube_mesh(3)
    cube.vertices = 2.0 * cube.vertices - 1.0  # [-1, 1]^3
    _write_msh22(tmp_path / "cube.msh", cube)
    m3 = gmsh_read(str(tmp_path / "cube.msh"))
    assert m3.dim == 3
    assert m3.num_cells == cube.num_cells
    assert np.isclose(m3.cell_volumes().sum(), 8.0, rtol=1e-6)
    assert np.all(m3.facet_markers[m3.exterior_facets] == 1)
