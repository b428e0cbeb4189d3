"""The port's training substrate; so far the reference's AdamW
(``optimizer.py``), which the GNN train steps use."""
