"""The harness's shared code: cell specs, the database, spans, traces,
byte counts, peaks and the result line."""
