"""rows_per_batch.serve (rows, the program's counter): the rows of the
batches the server completed from the window's start until every request
in flight at its end had returned, over those batches (`stats()`'s
`batch_rows` and `batches`); max_batch when every batch is full."""


def read(rec):
    if rec["kind"] != "serve" or not rec.get("served_batches"):
        return None
    return rec["served_rows"] / rec["served_batches"]
