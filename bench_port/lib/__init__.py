"""The harness's own pieces: finding files by name, the trace's arithmetic."""
