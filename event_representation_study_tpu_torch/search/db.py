"""BO-history persistence — the equivalent of gryffin's database_handler/
(sqlite/json/pickle plus the pandas csv/excel writers of
database_handler/pandas_writers/db_writer.py;
gryffin.py:479-491 db persistence hooks).

One handler, five formats. Every ``log_observations`` call appends the new
observation dicts (parameters + objective) with a monotonically increasing
``iteration`` stamp; ``load`` returns the full history. A copy of the JAX
package's ``search/db.py``: json, sqlite and pickle need only the standard
library; csv and xlsx need pandas, and raise naming it where it is absent.
"""
from __future__ import annotations

import json
import pathlib
import pickle
import sqlite3
from typing import Dict, List, Sequence

FORMATS = ("json", "sqlite", "pickle", "csv", "xlsx")


def _pandas():
    try:
        import pandas
    except ImportError as e:
        raise RuntimeError(
            "csv and xlsx history files need pandas, which is not installed; "
            "use format='json', 'sqlite' or 'pickle'"
        ) from e
    return pandas


class DatabaseHandler:
    """``format`` in {"json", "sqlite", "pickle", "csv", "xlsx"}
    (database_handler/: the json/pickle/sqlite werkzeugs plus the pandas
    DB_Writer's to_csv / to_excel outputs). ``csv`` and ``xlsx`` need pandas,
    and ``xlsx`` an Excel engine (openpyxl/xlsxwriter) too; each raises a
    clear error when absent."""

    def __init__(self, path, format: str = "json"):
        if format not in FORMATS:
            raise ValueError(f"unknown db format: {format}")
        self.path = pathlib.Path(path)
        self.format = format
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if format == "sqlite":
            with sqlite3.connect(self.path) as conn:
                conn.execute(
                    "CREATE TABLE IF NOT EXISTS observations ("
                    "iteration INTEGER, data TEXT)"
                )

    # -- write ---------------------------------------------------------
    def log_observations(self, observations: Sequence[Dict]):
        existing = self.load()
        start = len(existing)
        stamped = [
            dict(o, iteration=start + i) for i, o in enumerate(observations)
        ]
        if self.format == "sqlite":
            with sqlite3.connect(self.path) as conn:
                conn.executemany(
                    "INSERT INTO observations VALUES (?, ?)",
                    [(o["iteration"], json.dumps(o, default=float)) for o in stamped],
                )
        elif self.format == "json":
            all_obs = existing + stamped
            self.path.write_text(json.dumps(all_obs, indent=1, default=float))
        elif self.format in ("csv", "xlsx"):
            self._write_frame(existing + stamped)
        else:
            all_obs = existing + stamped
            with open(self.path, "wb") as f:
                pickle.dump(all_obs, f)

    def _write_frame(self, all_obs: List[Dict]):
        """pandas writers (db_writer.py:25-41): non-scalar values (e.g.
        list-valued parameters) are JSON-encoded per cell so the tabular
        round trip is lossless."""
        pd = _pandas()

        rows = [
            {k: (json.dumps(v) if isinstance(v, (list, dict, tuple)) else v)
             for k, v in o.items()}
            for o in all_obs
        ]
        frame = pd.DataFrame(rows)
        if self.format == "csv":
            frame.to_csv(self.path, index=False)
            return
        try:
            frame.to_excel(self.path, sheet_name="Sheet1", index=False)
        except (ImportError, ModuleNotFoundError) as e:
            raise RuntimeError(
                "xlsx output needs an Excel engine (pip install openpyxl); "
                "use format='csv' for a dependency-free table"
            ) from e

    # -- read ----------------------------------------------------------
    def load(self) -> List[Dict]:
        if not self.path.exists():
            return []
        if self.format == "sqlite":
            with sqlite3.connect(self.path) as conn:
                rows = conn.execute(
                    "SELECT data FROM observations ORDER BY iteration"
                ).fetchall()
            return [json.loads(r[0]) for r in rows]
        if self.format == "json":
            return json.loads(self.path.read_text())
        if self.format in ("csv", "xlsx"):
            return self._read_frame()
        with open(self.path, "rb") as f:
            return pickle.load(f)

    def _read_frame(self) -> List[Dict]:
        pd = _pandas()

        if self.format == "csv":
            frame = pd.read_csv(self.path)
        else:
            try:
                frame = pd.read_excel(self.path)
            except (ImportError, ModuleNotFoundError) as e:
                raise RuntimeError(
                    "xlsx input needs an Excel engine (openpyxl)"
                ) from e
        out = []
        for rec in frame.to_dict(orient="records"):
            row = {}
            for k, v in rec.items():
                if isinstance(v, str) and v[:1] in "[{(":
                    try:
                        v = json.loads(v)
                    except ValueError:
                        pass
                row[k] = v
            out.append(row)
        return out
