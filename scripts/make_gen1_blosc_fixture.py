"""Write the published-format Gen1 fixture, ``tests/data/gen1_blosc_seed7.h5``.

The published Gen1 split files hold Blosc-ZSTD chunks (HDF5 filter 32001)
under a version-0 superblock, the format h5py writes by default
(``libver="earliest"``). This script writes the port's synthetic Gen1
layout in that format: ``write_gen1_fixture(path, seed=7, blosc=True)``,
2 recordings of 20,000 events, chunks of 8,192 rows. It needs h5py, which
writes the chunks; ``events/h5lite.py`` reads them where h5py is absent
(``chip_smoke.py``'s ``gen1_published_format`` phase,
``tests/test_torch_port_h5_published.py``).

    python scripts/make_gen1_blosc_fixture.py [OUT]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

FIXTURE = pathlib.Path(__file__).resolve().parents[1] / "tests/data/gen1_blosc_seed7.h5"
SEED = 7


def write(path) -> pathlib.Path:
    import h5py  # noqa: F401  (the Blosc chunks are written through h5py)

    from event_representation_study_tpu_torch.data.gen1 import write_gen1_fixture

    return pathlib.Path(write_gen1_fixture(path, seed=SEED, blosc=True))


if __name__ == "__main__":
    out = write(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
    print(out, out.stat().st_size, "bytes")
