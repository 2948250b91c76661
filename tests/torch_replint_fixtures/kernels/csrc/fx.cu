// Declarations the PT002 / PT004 fixtures are checked against.
extern "C" int fx_scale(const int* ids, float* d, int n, float s, void* stream) { return 0; }
extern "C" int fx_pack(const int* ids, unsigned long long* keys, int n, void* stream) { return 0; }
extern "C" int fx_geometry(int which) { return which; }
