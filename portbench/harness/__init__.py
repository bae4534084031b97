"""The harness: finds a cell's files by name (:mod:`spec`), makes its
traffic from the seed (:mod:`traffic`), runs its window (:mod:`window`),
traces its layers (:mod:`trace`) and checks what the window produced
against the reference (:mod:`check`)."""
