"""
The reference's feature layouts, one module a layout:
``perfbench/reference/layouts/<kind>.py`` serves a configuration whose
``kind`` is ``<kind>``, found by that name (:func:`find`), so a layout
arrives as one new file.

A layout module has

* ``block(scene, band, centers, cells, queries, mask, precision,
  frame)``: the feature block (s, width) of band ``band`` of
  ``scene`` (a ``reference.features.Scene``) for the neighbourhoods
  ``mask`` (s, w) selects among the band's voxel centres ``centers``
  (s, w, 3) float32, with voxel indices ``cells`` (s, w, 3), around
  ``queries`` (s, 3); ``precision`` "float64" (the reference) or "tf32"
  (the lower-precision control, which may sum in frames ``frame`` (s,
  3) float32);

and may have

* ``work(scene)``: the layout's own work a band, for the roofline's
  count (``records["work"]``): a dict of lists, one entry a band;
* ``tied_rows(scene, rows)``: how many of the query ``rows`` rest on a
  decision a float32 program may take either way, beyond the radius
  ties that ``Scene.features`` enumerates.
"""

import importlib
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


def find(kind):
    """The layout module of ``kind``; raises ValueError, naming the
    layouts there are, where the folder holds no ``<kind>.py``."""
    names = sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")
    if kind not in names:
        raise ValueError(
            f"the reference has no layout {kind!r}: perfbench/reference/"
            f"layouts/ holds {', '.join(n + '.py' for n in names)}")
    return importlib.import_module(f"{__name__}.{kind}")
