"""Generation pipelines ported so far: Wan t2v."""
