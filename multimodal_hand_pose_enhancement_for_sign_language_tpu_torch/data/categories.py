"""Topic-category featurizer: videoID -> categoryID CSV maps.

The port's copy of the JAX package's ``data/categories.py``, the re-design
of the reference's proc_categ.py with paths as arguments instead of
hard-coded cluster paths (:6-12).  The bar charts import matplotlib and
pandas only when called.
"""

from __future__ import annotations

import csv
from collections import Counter, OrderedDict


def get_ids_categ(file_path: str, skip_header: bool = True) -> dict:
    """{video id (11 chars): category id} (proc_categ.py:16-26)."""
    reader = csv.reader(open(file_path))
    if skip_header:
        next(reader)
    id_categ_dict: dict = {}
    for row in reader:
        key = row[0]
        if key not in id_categ_dict:
            id_categ_dict[key] = int(row[1])
    return id_categ_dict


def get_clips_categ(clip_names, id_categ_dict) -> list:
    """Category per clip via the first 11 id chars (proc_categ.py:32-37)."""
    return [id_categ_dict[name[:11]] for name in clip_names]


def counter_to_relative(counter) -> dict:
    total = sum(counter.values())
    return {k: v / total for k, v in counter.items()}


def plot_barChart_categs(categs, key: str, out_dir: str = "."):
    """Absolute + relative class-frequency bar charts
    (proc_categ.py:48-60)."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import pandas as pd

    count = OrderedDict(Counter(categs))
    paths = []
    for name, data in (
        (f"barChart_absFreq_classes_{key}.png", count),
        (f"barChart_relFreq_classes_{key}.png", counter_to_relative(count)),
    ):
        df = pd.DataFrame.from_dict(data, orient="index")
        ax = df.sort_values(by=0, ascending=False).plot(
            kind="bar", title=f"Examples per class in {key} set"
        )
        fig = ax.get_figure()
        path = os.path.join(out_dir, name)
        fig.savefig(path)
        paths.append(path)
    return paths
