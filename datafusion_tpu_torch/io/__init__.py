"""Host-side readers: NDJSON and Parquet files -> padded columnar
batches (`io.readers`), and the pyarrow confinement threads
(`io.io_thread`).  CSV is read by the native parser
(`native/csv.py`)."""
