"""Host-side readers: CSV, NDJSON and Parquet files -> padded columnar
batches (`io.readers`), and the pyarrow confinement threads
(`io.io_thread`, the JAX package's counterpart; no reader of the port
uses pyarrow).  CSV is parsed by the port's own parser (`native/csv.py`
over `native/csv.cpp`), Parquet by its own reader (`native/parquet.py`)."""
