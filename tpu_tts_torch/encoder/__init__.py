"""Speaker (d-vector) encoders: configs, models, losses, data and weights."""
