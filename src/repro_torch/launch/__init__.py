"""Launch layer: production mesh, step builder, dry run, H100 roofline."""
