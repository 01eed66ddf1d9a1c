# Parity with the reference's Makefile `make test` entry (Makefile:57-66):
# the suite runs single-device AND on a virtual 8-device mesh (conftest)
# and spawns real 2-process Gloo collectives (the mpirun -np 4 analog,
# .travis.yml:21-26).
.PHONY: test bench planner clean

test:
	python -m pytest tests/ -q

bench:
	python bench.py

planner:
	python -c "from graphmat.native import load_planner; \
	           assert load_planner() is not None, 'planner build failed'"

clean:
	rm -f graphmat/native/libgmplanner.so
