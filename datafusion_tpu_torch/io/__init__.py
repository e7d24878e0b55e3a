"""Host-side readers: NDJSON and Parquet files -> padded columnar
batches (`io.readers`), and the pyarrow confinement threads
(`io.io_thread`, the JAX package's counterpart; no reader of the port
uses pyarrow).  CSV is read by the native parser (`native/csv.py`),
Parquet by the native reader (`native/parquet.py`)."""
