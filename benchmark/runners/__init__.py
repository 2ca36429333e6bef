"""One runner a traffic kind: ``run(ctx)`` runs one cell once."""
