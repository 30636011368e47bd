"""The yardstick's frozen counts: the card's published peaks and the
bytes and operations each kernel's work needs, from the cell's shapes and
the reference's live-lane counts, never from the program."""
