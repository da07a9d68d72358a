"""ECF8 core: exponent-concentration theory and lossless fp8 compression
(the reference's ``repro.core``: the same submodules and re-exports).

``store`` and its names load on first use (module ``__getattr__``):
``store`` imports the kernels' dispatch point, whose page decode imports
``kvcache.codec``, which imports this package's ``huffman``."""
from . import fp8, theory, stats, huffman, paper_format, tpu_format, fixedrate  # noqa: F401

_STORE_NAMES = ("CompressedTensor", "compress_array", "compress_stacked",
                "compress_tree", "fp8_cast_tree", "is_compressed",
                "materialize")


def __getattr__(name):
    if name == "store" or name in _STORE_NAMES:
        import importlib
        store = importlib.import_module(f"{__name__}.store")
        return store if name == "store" else getattr(store, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
